"""Reading a torch.profiler window: device time per span and per kernel,
the device's busy time and idle share (copied from ``chip_smoke.py``'s
``spans_and_kernels``), and the breakdown the result line carries."""
from __future__ import annotations

from typing import List, Tuple


def _cuda_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def spans_and_kernels(prof, wall_s: float) -> dict:
    """Device seconds per kernel (or copy), the device ranges of the
    ``annotate`` spans, and the union of the device's intervals, from one
    profiled window of ``wall_s`` host seconds (synced). A span's device
    range runs from its first kernel's start to its last one's end; busy time
    is the union of the kernels' own intervals."""
    from torch.autograd import DeviceType

    kernels: List[Tuple[float, int, str]] = [
        (e.self_device_time_total / 1e6, e.count, e.key) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kernels.sort(reverse=True)
    ivals = sorted((e.time_range.start, e.time_range.end) for e in _cuda_events(prof))
    # a span's device row: from its first kernel's start to its last one's end
    span_ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.is_user_annotation and e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, -float("inf")
    for s0, s1 in ivals:
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    return {"window_s": wall_s, "busy_s": busy_us / 1e6, "kernels": kernels,
            "intervals": ivals, "span_ranges": span_ranges}


def idle_gaps(prof, ivals, top: int = 10) -> List[list]:
    """The longest gaps between device work inside the window, each named by
    what the host was doing when it began: the innermost host span or
    operator open at that time."""
    from torch.autograd import DeviceType

    gaps, end = [], None
    for s0, s1 in ivals:
        if end is not None and s0 > end:
            gaps.append((s0 - end, end))
        end = s1 if end is None else max(end, s1)
    gaps.sort(reverse=True)
    gaps = gaps[:top]
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    out = []
    for length, at in gaps:
        best = None
        for e in host:
            if e.time_range.start <= at <= e.time_range.end:
                if best is None or e.time_range.start >= best.time_range.start:
                    best = e
        out.append([best.name if best is not None else "host", length / 1e6])
    return out


def breakdown(prof, summary: dict, top: int = 10) -> dict:
    return {"device_ops": [[k[:120], s] for s, _, k in summary["kernels"][:top]],
            "idle_gaps": idle_gaps(prof, summary["intervals"], top)}
