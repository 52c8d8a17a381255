"""Tracing and memory reports (counterpart of waldo_tpu/utils/profiling.py).

``annotate`` is ``torch.profiler.record_function`` under the same span names
the JAX package uses (``warper/alpha_ctx_fused``, ``lvd/encode_input``, ...),
so a torch profiler trace maps one to one onto the JAX stage traces.

Usage:
    with trace("logs/profile"):          # a Chrome trace of the block
        step(...)
    with annotate("decode_output"):      # a named span inside a trace
        ...
    print(memory_stats())                # per-card memory use
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler (host and, where a card is
    present, device activity) and write it as a Chrome trace
    ``trace_<time>.json`` into ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)


def memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device, in GiB: the bytes allocated now, the peak since the
    last reset and the card's total; empty without a card (the JAX CPU
    device reports none either)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": s.get("allocated_bytes.all.current", 0) / 2 ** 30,
            "peak_bytes_gb": s.get("allocated_bytes.all.peak", 0) / 2 ** 30,
            "bytes_limit_gb": total / 2 ** 30,
        }
    return out


def provenance(**extra) -> Dict[str, object]:
    """A stamp for a results file: the git revision (with "-dirty" when the
    tree has changes), the time, the backend ("cuda" or "cpu") and the
    device's name, and the caller's fields."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=repo,
                             capture_output=True, text=True, timeout=10).stdout.strip() or "unknown"
        dirty = bool(subprocess.run(["git", "status", "--porcelain"], cwd=repo,
                                    capture_output=True, text=True, timeout=10).stdout.strip())
        if dirty:
            rev += "-dirty"
    except Exception:
        rev = "unknown"
    cuda = torch.cuda.is_available()
    stamp = {
        "git_rev": rev,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "backend": "cuda" if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }
    stamp.update(extra)
    return stamp


def log_memory(logger=None, step: Optional[int] = None, prefix: str = "mem"):
    stats = memory_stats()
    for dev, s in stats.items():
        if logger is not None and step is not None:
            logger.log_scalar(f"{prefix}/{dev}/in_use_gb", s["bytes_in_use_gb"], step)
        else:
            print(f"[{prefix}] {dev}: {s['bytes_in_use_gb']:.2f} GiB in use "
                  f"(peak {s['peak_bytes_gb']:.2f} / limit {s['bytes_limit_gb']:.2f})")
    return stats
