"""Hand-written CUDA kernels of the port, their wrappers and launch counts.

``KERNELS`` maps a kernel's name to its ``CudaKernel`` (launch count,
source); ``build_all`` compiles every source in parallel."""
from .bias_act import BIAS_ACT, bias_act_cuda
from .build import build
from .grid_sample import (GRID_SAMPLE, GRID_SAMPLE_BWD, GRID_SAMPLE_PER_CHANNEL,
                          GRID_SAMPLE_PER_CHANNEL_BWD, grid_sample_bwd_cuda, grid_sample_cuda,
                          grid_sample_per_channel_bwd_cuda, grid_sample_per_channel_cuda)
from .planes import PLANE_BOXES, plane_boxes_cuda
from .warp_alpha_ctx import WARP_ALPHA_CTX, warp_alpha_ctx_cuda

KERNELS = {"warp_alpha_ctx": WARP_ALPHA_CTX, "grid_sample": GRID_SAMPLE,
           "grid_sample_per_channel": GRID_SAMPLE_PER_CHANNEL,
           "grid_sample_bwd": GRID_SAMPLE_BWD,
           "grid_sample_per_channel_bwd": GRID_SAMPLE_PER_CHANNEL_BWD,
           "bias_act": BIAS_ACT, "plane_boxes": PLANE_BOXES}


def build_all():
    return build(sorted({k.source for k in KERNELS.values()}))


def reset_launches() -> None:
    for k in KERNELS.values():
        k.reset()
