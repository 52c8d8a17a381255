from .transform import (Block, ClsAttention, CrossAttention, CustomNorm, Dense,
                        FullAttention, Mlp, MultiBlocks, ObjAttention)
from .conv import ConvPatchProj, UNet, conv3x3, conv_down, deconv_up
from .init import init_module, resolve_dtype
