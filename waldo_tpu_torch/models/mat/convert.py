"""The reference's MAT pickle -> the port's MAT weights (counterpart of
waldo_tpu/models/mat/convert.py).

Two halves:

1. ``load_network_pkl`` reads the reference's StyleGAN2-style persistence
   pickles (Places_512_FullData.pkl) without the reference's code. The
   pickle stores each persistent module as a reduce-call to
   ``torch_utils.persistence._reconstruct_persistent_obj(meta)`` whose
   ``meta.state`` is the module's ``__dict__`` (``_parameters``,
   ``_buffers``, ``_modules``). A custom unpickler takes that global and
   builds plain shells, flattened to a torch-style ``name -> numpy`` state
   dict; no module runs (torch only decodes the tensor storages).

2. ``convert_state_dict`` maps the torch names and layouts onto the JAX
   package's flax Generator tree, which ``MatInpainter(weights_path=...)``
   reads through ``waldo_tpu_torch.convert.mat_from_jax``: conv (O,I,kh,kw)
   and modulated conv (1,O,I,kh,kw) -> (kh,kw,I,O), dense (O,I) -> (I,O);
   the ``noise_const`` buffers -> the "noise_const" collection,
   ``mapping.w_avg`` -> "w_stats". ``convert_mat_weights`` writes the
   ``.npz`` the JAX converter writes. A layer built with ``use_bias=False``
   has no bias in the state dict, in the template (``module_template``) or
   in the tree.
"""
from __future__ import annotations

import math
import pickle
import re
from typing import Any, Dict, Optional

import numpy as np

from ..convert import _flat_shapes


# ---------------------------------------------------------------------------
# persistence-pickle reading
# ---------------------------------------------------------------------------

class _PersistentNode:
    """Shell for a persistent module: holds its pickled __dict__."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def _reconstruct_persistent_obj(meta):
    node = _PersistentNode()
    state = meta["state"] if isinstance(meta, dict) else meta.state
    node.__dict__.update(state)
    return node


class _EasyDict(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


class _RefUnpickler(pickle.Unpickler):
    """Resolves the reference's globals without the reference's code."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj":
            return _reconstruct_persistent_obj
        if name == "EasyDict":
            return _EasyDict
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            # a class of the reference's own: a shell that carries its state
            # is all the weights need
            return type(name, (_PersistentNode,), {})


def _to_numpy(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _flatten_module(node, prefix: str, out: Dict[str, np.ndarray]):
    d = node if isinstance(node, dict) else node.__dict__
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = _to_numpy(p)
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None:
            out[prefix + name] = _to_numpy(b)
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            _flatten_module(m, prefix + name + ".", out)


def load_network_pkl(path: str, key: str = "G_ema") -> Dict[str, np.ndarray]:
    """A reference persistence pickle -> flat torch-style state dict.

    ``key`` selects the entry of the pickled dict ('G', 'D', 'G_ema'); for a
    bare network object, pass key=None."""
    with open(path, "rb") as f:
        data = _RefUnpickler(f).load()
    net = data if key is None else data[key]
    out: Dict[str, np.ndarray] = {}
    _flatten_module(net, "", out)
    return out


# ---------------------------------------------------------------------------
# name and layout mapping
# ---------------------------------------------------------------------------

_SKIP = re.compile(r"(resample_filter|attn_mask)$")
_RULES = [
    (re.compile(r"enc\.EncConv_Block_(\d+)x\1\."),
     lambda m: f"enc.b{int(math.log2(int(m.group(1))))}."),
    (re.compile(r"first_stage\.tran\.(\d+)\."), r"first_stage.tran\1."),
    # the reference names the resampler `downsample` in the upsampling
    # stages (tran3, tran4) too; the flax tree names it by direction
    (re.compile(r"first_stage\.tran([34])\.downsample\."), r"first_stage.tran\1.upsample."),
    (re.compile(r"\.blocks\.(\d+)\."), r".block\1."),
    (re.compile(r"\.mlp\.fc(\d)"), r".mlp_fc\1"),
    (re.compile(r"first_stage\.enc_conv\.(\d+)\."), r"first_stage.enc_conv\1."),
    (re.compile(r"first_stage\.down_conv\.(\d+)\."), r"first_stage.down_conv\1."),
    (re.compile(r"first_stage\.dec_conv\.(\d+)\."), r"first_stage.dec_conv\1."),
    (re.compile(r"to_style\.conv\.(\d+)\."), r"to_style.conv\1."),
]


def torch_key_to_flax(key: str):
    """(collection, path tuple) of one torch state-dict key; None to skip."""
    if _SKIP.search(key):
        return None
    if key == "mapping.w_avg":
        return ("w_stats", ("mapping", "w_avg"))
    k = key
    for pat, rep in _RULES:
        k = pat.sub(rep, k)
    parts = k.split(".")
    if parts[-1] == "noise_const":
        return ("noise_const", tuple(parts[:-1]) + ("n",))
    return ("params", tuple(parts))


def _convert_leaf(name: str, arr: np.ndarray) -> np.ndarray:
    if name.endswith("weight"):
        if arr.ndim == 5:  # modulated conv (1,O,I,kh,kw)
            return np.ascontiguousarray(arr[0].transpose(2, 3, 1, 0))
        if arr.ndim == 4:  # conv (O,I,kh,kw)
            return np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        if arr.ndim == 2:  # dense (O,I)
            return np.ascontiguousarray(arr.T)
    return arr


def convert_state_dict(sd: Dict[str, np.ndarray],
                       template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Torch state dict -> flax variables {"params", "noise_const",
    "w_stats"} as nested dicts of numpy arrays.

    With ``template`` (a tree of the same structure, arrays or shapes'
    holders) every converted leaf is shape-checked against it, and missing
    or extra keys raise."""
    tree: Dict[str, Any] = {}
    for key, arr in sd.items():
        mapped = torch_key_to_flax(key)
        if mapped is None:
            continue
        col, path = mapped
        leaf = _convert_leaf(key, np.asarray(arr, np.float32))
        node = tree.setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    if template is not None:
        t_paths, c_paths = _flat_shapes(template), _flat_shapes(tree)
        missing = sorted(set(t_paths) - set(c_paths))
        extra = sorted(set(c_paths) - set(t_paths))
        if missing or extra:
            raise ValueError(f"key mismatch: missing={missing[:8]} extra={extra[:8]}")
        for p, shape in t_paths.items():
            if c_paths[p] != shape:
                raise ValueError(f"shape mismatch at {p}: {c_paths[p]} vs {shape}")
    return tree


def module_template(module) -> Dict[str, Any]:
    """The flax variables' paths and shapes of a port MAT module (which
    carries the flax names), as nested dicts of zero-strided arrays: a layer
    built with ``use_bias=False`` has no "bias" leaf, as in the reference's
    state dict."""
    tree: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        parts = key.split(".")
        if parts[-1] == "resample_filter":
            continue
        if key.endswith("mapping.w_avg") or key == "w_avg":
            col, path = "w_stats", parts
        elif parts[-1] == "noise_const":
            col, path = "noise_const", parts[:-1] + ["n"]
        else:
            col, path = "params", parts
        shape = tuple(t.shape)
        if col == "params" and parts[-1] == "weight" and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # (O,I,kh,kw) -> (kh,kw,I,O)
        elif col == "params" and parts[-1] == "weight" and len(shape) == 2:
            shape = shape[::-1]
        node = tree.setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.broadcast_to(np.float32(0), shape)
    return tree


def generator_template(img_resolution: int = 512) -> Dict[str, Any]:
    """``module_template`` of a MAT Generator at ``img_resolution``."""
    from .mat import Generator

    return module_template(Generator(img_resolution=img_resolution))


def convert_mat_weights(pkl_path: str, out_path: str,
                        img_resolution: int = 512, key: str = "G_ema") -> str:
    """Places_512_FullData.pkl (the reference's pickle) -> the ``.npz``
    that ``MatInpainter(weights_path=...)`` reads: a pickled ``params``
    object holding the flax variables, as the JAX converter writes it."""
    sd = load_network_pkl(pkl_path, key=key)
    tree = convert_state_dict(sd, template=generator_template(img_resolution))
    np.savez(out_path, params=np.asarray(tree, dtype=object))
    return out_path
