from .lvd import LVDNet, bg_alpha_buffer, compute_occ
from .flp import FLPNet
from .wif import WIFNet
from .warper import Warper, WarpGrids
from .synthesizer import Synthesizer
