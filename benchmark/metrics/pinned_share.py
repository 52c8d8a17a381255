"""The share, in %, of the device time of the copies between host and card
(the trace's ``Memcpy HtoD`` / ``Memcpy DtoH`` rows) whose rows say the host
side was page-locked (``Pinned`` in the row's name, as against ``Pageable``)."""


def read(ctx):
    rows = [(s, name) for s, _, name in ctx.summary["kernels"]
            if name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    total = sum(s for s, _ in rows)
    if not rows or total <= 0:
        return None
    return 100.0 * sum(s for s, name in rows if "Pinned" in name) / total
