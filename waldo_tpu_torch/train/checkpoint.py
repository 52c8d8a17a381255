"""Per-net checkpoints (counterpart of waldo_tpu/train/checkpoint.py).

A net's parameters are saved as the JAX package's parameter tree
(``convert.to_jax``), one ``.npz`` per slot keyed by flax path ("params/
encoder/.../kernel"), under checkpoints/<signature>/: numbered slots
``<net>_<iter>.npz`` and named ones (``latest``, ``best_vid``) that replace
their predecessors, each with a ``.iter`` file naming its iteration.
Restore by iteration or name; a missing ``latest`` falls back to the
highest numbered slot.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np


def normalize_which(which):
    """None and "" mean "latest"; anything else is kept verbatim (0 and "0"
    name iteration 0, not the latest slot)."""
    return "latest" if which in (None, "") else str(which)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


class CheckpointManager:
    def __init__(self, checkpoint_path: str):
        self.root = os.path.abspath(checkpoint_path)
        os.makedirs(self.root, exist_ok=True)

    def _slot(self, root: str, label: str, which: str) -> str:
        return os.path.join(root, f"{label}_{which}.npz")

    def _numbered(self, root: str, label: str):
        if not os.path.isdir(root):
            return []
        pat = re.compile(rf"{re.escape(label)}_(\d+)\.npz")
        return [int(m.group(1)) for f in os.listdir(root) for m in [pat.fullmatch(f)] if m]

    def save(self, label: str, tree, it: int, name: Optional[str] = None) -> None:
        """Save one net's tree (nested dicts of numpy arrays); a named slot
        records the iteration it holds."""
        path = self._slot(self.root, label, name if name is not None else str(it))
        tmp = path[:-4] + ".tmp.npz"
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path)
        if name is not None:
            with open(path[:-4] + ".iter", "w") as f:
                f.write(str(it))

    def _resolve(self, label: str, which: str, root: str) -> str:
        path = self._slot(root, label, which)
        if os.path.exists(path):
            return path
        its = self._numbered(root, label)
        if which == "latest" and its:
            return self._slot(root, label, str(max(its)))
        raise FileNotFoundError(path)

    def restore(self, label: str, template, which: str = "latest",
                load_path: Optional[str] = None, strict: bool = False):
        """One net's tree, restored into ``template`` (nested dicts of numpy
        arrays). strict=False keeps the reference's tolerant loader: a saved
        leaf whose shape differs from the template's is pruned (the
        template's value kept), a template leaf the checkpoint lacks keeps
        its value, and both are reported. strict=True raises on either."""
        root = os.path.abspath(load_path) if load_path else self.root
        path = self._resolve(label, which, root)
        with np.load(path) as z:
            saved = {k: z[k] for k in z.files}
        pruned, missing = [], []

        def merge(tree, prefix=""):
            out = {}
            for k, t_leaf in tree.items():
                key = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(t_leaf, dict):
                    out[k] = merge(t_leaf, key)
                elif key not in saved:
                    missing.append(key)
                    out[k] = t_leaf
                elif saved[key].shape != np.shape(t_leaf):
                    pruned.append(f"{key} {saved[key].shape} -> {np.shape(t_leaf)}")
                    out[k] = t_leaf
                else:
                    out[k] = saved[key].astype(np.asarray(t_leaf).dtype)
            return out

        out = merge(template)
        extra = sorted(set(saved) - set(_flatten(template)))
        if strict and (pruned or missing or extra):
            raise ValueError(f"strict restore of {label} from {path}: pruned {pruned}, "
                             f"missing {missing}, unused {extra}")
        if pruned or missing:
            print(f"[ckpt] non-strict restore of {label} from {path}: "
                  f"pruned (shape mismatch): {pruned or 'none'}; "
                  f"missing (kept init): {missing or 'none'}", flush=True)
        return out

    def exists(self, label: str, which: str = "latest", load_path: Optional[str] = None):
        root = os.path.abspath(load_path) if load_path else self.root
        return os.path.exists(self._slot(root, label, which))

    def latest_iter(self, label: str) -> Optional[int]:
        p = os.path.join(self.root, f"{label}_latest.iter")
        if os.path.exists(p):
            with open(p) as f:
                return int(f.read().strip())
        its = self._numbered(self.root, label)
        return max(its) if its else None
