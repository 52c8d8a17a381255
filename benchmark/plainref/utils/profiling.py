"""No spans in the reference: the program's traced window is closed before
the reference runs, and its spans are the program's alone."""
from __future__ import annotations

import contextlib


def annotate(name: str):
    return contextlib.nullcontext()
