"""The device an entry point runs on: the card unless the caller asks for
another."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"waldo_tpu_torch asks for device {str(dev)!r} (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run on "
            "the CPU")
    return dev
