"""Liveness heartbeat for long-running train loops (the port's copy of
waldo_tpu/utils/heartbeat.py).

Loops call ``beat(it)`` once per iteration; when WALDO_HEARTBEAT_FILE is set
the current iteration lands there atomically, so a supervisor can kill and
retry a child whose heartbeat goes stale. A no-op, with no system call after
the first check, when the variable is unset.
"""
from __future__ import annotations

import os

_PATH = None
_CHECKED = False


def beat(it) -> None:
    global _PATH, _CHECKED
    if not _CHECKED:
        _PATH = os.environ.get("WALDO_HEARTBEAT_FILE") or None
        _CHECKED = True
    if _PATH is None:
        return
    try:
        tmp = _PATH + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(it))
        os.replace(tmp, _PATH)
    except OSError:
        pass
