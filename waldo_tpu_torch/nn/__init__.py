from .transform import (Block, BlockCausalAttention, ClsAttention, CrossAttention,
                        CtxAttention, CustomNorm, Dense, FullAttention, Mlp, MultiBlocks,
                        ObjAttention, SeedAttention, Skip2Attention, SkipAttention,
                        get_causal_mask)
from .conv import ConvPatchProj, UNet, conv3x3, conv_down, deconv_up
from .init import init_module, resolve_dtype
from .gan import Discriminator, get_gan_loss
