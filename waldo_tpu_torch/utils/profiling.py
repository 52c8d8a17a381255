"""Named trace regions (counterpart of waldo_tpu/utils/profiling.py).

``annotate`` is ``torch.profiler.record_function`` under the same span names
the JAX package uses (``warper/alpha_ctx_fused``, ``lvd/encode_input``, ...),
so a torch profiler trace maps one to one onto the JAX stage traces."""
from __future__ import annotations

from torch.profiler import record_function


def annotate(name: str):
    return record_function(name)
