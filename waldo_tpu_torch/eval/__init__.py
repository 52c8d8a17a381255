"""Evaluation nets (counterpart of waldo_tpu/eval/): the LPIPS distance so
far."""
from .lpips import LPIPS, convert_lpips_state_dict
