#!/usr/bin/env python3
"""Convert a JAX training run's checkpoint slots for the PyTorch port.

The JAX package saves each net's parameters as an orbax directory per slot
(checkpoints/<signature>/<net>_<iter> and named slots such as <net>_latest,
with a <net>_<name>.iter file naming the iteration). The port reads one
.npz per slot, keyed by flax path ("params/encoder/.../kernel"), with the
same names and .iter files (waldo_tpu_torch/train/checkpoint.py). This
script restores each slot through the JAX package's CheckpointManager and
writes the port's file; the run's config.json is copied beside them.

    python scripts/jax_slots_to_torch.py SRC DST [--nets pe pg ii] [--which latest 1000]

SRC is the JAX run's checkpoint directory, DST the port's (for example the
--s_load_path of a port run). Without --which every slot of the nets is
converted; a --which slot is found as CheckpointManager.restore finds it
(a missing "latest" falls back to the highest numbered slot). The script
needs the JAX package, not the port.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from waldo_tpu.train.checkpoint import CheckpointManager, normalize_which  # noqa: E402

NETS = ("pe", "pg", "ii")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def slots(src, net):
    """The slot tags (iterations and names) of ``net`` in ``src``."""
    pat = re.compile(rf"{net}_(.+)")
    return sorted(m.group(1) for f in os.listdir(src)
                  for m in [pat.fullmatch(f)] if m and os.path.isdir(os.path.join(src, f)))


def convert_slot(mgr, net, which, dst):
    """Restore one slot of ``net`` and write it as the port's
    ``<net>_<which>.npz`` (with the ``.iter`` file a named slot has).
    Returns the path written."""
    src_path = mgr._resolve(net, which, mgr.root)
    tree = mgr.restore(net, None, which=which)
    path = os.path.join(dst, f"{net}_{which}.npz")
    tmp = path[:-4] + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    it_file = src_path + ".iter"
    if os.path.exists(it_file):
        shutil.copyfile(it_file, path[:-4] + ".iter")
    elif not which.isdigit() and re.fullmatch(rf"{net}_(\d+)", os.path.basename(src_path)):
        # a named slot that fell back to a numbered one
        with open(path[:-4] + ".iter", "w") as f:
            f.write(os.path.basename(src_path).split("_", 1)[1])
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the JAX run's checkpoint directory")
    ap.add_argument("dst", help="the directory to write the port's slots into")
    ap.add_argument("--nets", nargs="+", default=list(NETS), choices=NETS)
    ap.add_argument("--which", nargs="+", default=None,
                    help="slots to convert (iterations or names); default: every slot")
    args = ap.parse_args(argv)
    mgr = CheckpointManager(args.src)
    os.makedirs(args.dst, exist_ok=True)
    written = []
    for net in args.nets:
        tags = [normalize_which(w) for w in args.which] if args.which else slots(mgr.root, net)
        for which in tags:
            written.append(convert_slot(mgr, net, which, args.dst))
            print(f"{net} {which} -> {written[-1]}", flush=True)
    cfg = os.path.join(mgr.root, "config.json")
    if os.path.exists(cfg):
        shutil.copyfile(cfg, os.path.join(args.dst, "config.json"))
    if not written:
        raise SystemExit(f"no slot of {args.nets} in {mgr.root}")
    return written


if __name__ == "__main__":
    main()
