"""Model FLOPs of the work inside a block: the formulas of
``torch.utils.flop_counter`` (convolutions, matrix products, attention,
forward and backward) summed over the operators dispatched, as
FlopCounterMode counts them (a composite operator is decomposed first, so
``matmul`` counts as its ``mm``), without FlopCounterMode's module hooks,
which refuse parameters that ask for a gradient under inference mode. The
count depends on shapes only."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_META = {torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default, torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default, torch.ops.prim.layout.default}


class ModelFlops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META:
            return NotImplemented
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out
