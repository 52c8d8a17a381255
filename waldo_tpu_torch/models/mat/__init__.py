from .mat import Generator
from .inpainter import MatInpainter, expand_mask
