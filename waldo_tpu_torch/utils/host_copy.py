"""Copies between host numpy arrays and the card through page-locked memory
that is reused from call to call.

A pageable ``torch.from_numpy(a).to("cuda", non_blocking=True)`` overlaps
nothing: CUDA stages it through a small page-locked buffer of its own, at a
fraction of the link's rate, and a fresh page-locked block costs a
``cudaHostAlloc`` of tens of ms a copy. ``Staging.to_device`` walks each
array's bytes in chunks through two page-locked slots made once: the host
fills one slot while the card reads the other. ``to_host`` copies tensors
back into page-locked blocks of PyTorch's caching host allocator, which a
block rejoins when the caller drops its array. On the CPU both do what a
plain ``.to`` / ``.cpu()`` does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# bytes of one staging slot: the fastest of 8-128 MB for the 587 MB layout
# one-hot of Cityscapes' test.sh on an H100 (PERF.md)
CHUNK_BYTES = 16 << 20


class Staging:
    """Two staging slots, made on first use and reused by every later copy,
    each with a CUDA event recorded after the copy that reads it: a slot is
    refilled only once the card has read what it held."""

    def __init__(self):
        self.slots: list = []
        self.events: list = []
        self.allocations = 0  # slots allocated (page-locked on a card)
        self._turn = 0

    def to_device(self, arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
        """Device tensors of ``arrays``, same shapes and dtypes. On a card the
        copies are queued on the current stream and may still run when this
        returns; the arrays may be changed once it has returned."""
        device = torch.device(device)
        if device.type != "cuda":
            return {k: torch.from_numpy(v).to(device, non_blocking=True)
                    for k, v in arrays.items()}
        return self._to_device(arrays, device, CHUNK_BYTES)

    def _to_device(self, arrays, device, chunk_bytes: int):
        on_card = device.type == "cuda"
        if not self.slots:
            self.slots = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=on_card)
                          for _ in range(2)]
            self.events = [torch.cuda.Event() if on_card else None for _ in range(2)]
            self.allocations += 2
        stream = torch.cuda.current_stream(device) if on_card else None
        return {k: self._copy(v, device, stream) for k, v in arrays.items()}

    def _copy(self, a: np.ndarray, device, stream) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))  # keeps 0-d arrays 0-d
        dst = torch.empty(src.shape, dtype=src.dtype, device=device)
        src_b, dst_b = src.reshape(-1).view(torch.uint8), dst.view(-1).view(torch.uint8)
        size, chunk = src_b.numel(), self.slots[0].numel()
        for lo in range(0, size, chunk):
            n = min(chunk, size - lo)
            slot, event = self.slots[self._turn], self.events[self._turn]
            if event is not None:
                event.synchronize()  # the card has read the slot's last chunk
            slot[:n].copy_(src_b[lo:lo + n])
            dst_b[lo:lo + n].copy_(slot[:n], non_blocking=True)
            if event is not None:
                event.record(stream)
            self._turn ^= 1
        return dst


def to_host(tensors: Dict[str, torch.Tensor], device) -> Dict[str, np.ndarray]:
    """float32 numpy arrays of ``tensors``. On a card each goes into a
    page-locked block of the caching host allocator, with one synchronisation
    after the last copy; an array holds its block until the caller drops it."""
    if torch.device(device).type != "cuda":
        return {k: v.float().cpu().numpy() for k, v in tensors.items()}
    host = {}
    for k, v in tensors.items():
        host[k] = torch.empty(v.shape, dtype=torch.float32, pin_memory=True)
        host[k].copy_(v.float(), non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return {k: h.numpy() for k, h in host.items()}
