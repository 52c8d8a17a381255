from .grid import get_grid, get_gaussian_kernel, get_circle
from .grid_sample import (grid_sample, grid_sample_ctx, grid_sample_multigrid,
                          warp_alpha_ctx)
from .tps import TPSWarp
from .inverse_warp import InverseWarp
from .image import EdgeExtractor, gaussian_blur, resize
