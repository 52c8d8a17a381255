"""The reference's core-net checkpoints (torch ``{pe,pg,ii}_net_*.pth``) ->
the port (counterpart of waldo_tpu/models/convert.py).

The reference saves a plain torch state dict per net (``pe`` = LVD, ``pg`` =
FLP, ``ii`` = WIF). The rule tables below map its names and layouts onto the
JAX package's flax paths, as the JAX converter does (this is the port's own
copy of its rules), and ``waldo_tpu_torch.convert.from_jax`` carries that
tree into the port's modules. ``load_reference_checkpoints`` does both.

Layout transforms (torch -> flax):
  dense  (O, I)          -> kernel (I, O)
  conv   (O, I, kh, kw)  -> kernel (kh, kw, I, O)
  deconv (I, O, kh, kw)  -> kernel (kh, kw, I, O), spatially flipped
  copy   identical shapes (embeddings, norm scale/bias, noise_strength)

The reference's buffers that the nets recompute as constants (pose bias and
multiplier tables, TPS target points, occlusion bias, border masks) are
checked against the checkpoint, never loaded: a mismatch (an
``rd_translate_bias`` run, whose random bias cannot be reproduced) raises
with the key.
"""
from __future__ import annotations

import math
import os
import re
from glob import glob
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# rule: (torch_key, flax_path "a/b/c", kind)
Rule = Tuple[str, str, str]

_ATTN_CLS = {
    "full": "FullAttention_0",
    "full_with_cond_norm": "FullAttention_0",
    "cross": "CrossAttention_0",
    "obj": "ObjAttention_0",
    "cls": "ClsAttention_0",
    "ctx": "CtxAttention_0",
    "seed": "SeedAttention_0",
}

# torch linear name -> (flax Dense index, has_bias), per attention type
_ATTN_LINS = {
    "full": [("qkv", 0, False), ("proj", 1, True)],
    "full_with_cond_norm": [("qkv", 0, False), ("proj", 1, True)],
    "cross": [("q", 0, False), ("kv", 1, False), ("proj", 2, True)],
    "obj": [("q", 0, False), ("kv", 1, False), ("proj", 2, True)],
    "cls": [("q", 0, False), ("kv", 1, False), ("proj", 2, True)],
    "ctx": [("q", 0, False), ("kv", 1, False), ("proj", 2, True)],
    "seed": [("qkv", 0, False), ("kv_cls", 1, False), ("proj", 2, True)],
}


def _norm_rules(t: str, f: str, norm_layer: str) -> List[Rule]:
    """CustomNorm params: torch `{t}.norm.{weight,bias}` -> flax subtree."""
    if norm_layer == "ln":
        return [(f"{t}.norm.weight", f"{f}/LayerNorm_0/scale", "copy"),
                (f"{t}.norm.bias", f"{f}/LayerNorm_0/bias", "copy")]
    if norm_layer == "ln2d":
        return [(f"{t}.norm.weight", f"{f}/GroupNorm_0/scale", "copy"),
                (f"{t}.norm.bias", f"{f}/GroupNorm_0/bias", "copy")]
    if norm_layer in ("pn", "ln_not_affine"):
        return []
    raise ValueError(norm_layer)


def _dense_rules(t: str, f: str, has_bias: bool = True) -> List[Rule]:
    rules = [(f"{t}.weight", f"{f}/kernel", "dense")]
    if has_bias:
        rules.append((f"{t}.bias", f"{f}/bias", "copy"))
    return rules


def _block_rules(t: str, f: str, block_type: str, norm_layer: str,
                 noise: bool = False) -> List[Rule]:
    """One transformer Block."""
    cond = block_type == "full_with_cond_norm"
    rules: List[Rule] = []
    rules += _norm_rules(f"{t}.norm1", f"{f}/CustomNorm_0", norm_layer)
    rules += _norm_rules(f"{t}.norm2", f"{f}/CustomNorm_1", norm_layer)
    attn_cls = _ATTN_CLS[block_type]
    for lin, idx, has_bias in _ATTN_LINS[block_type]:
        rules += _dense_rules(f"{t}.attn.attn.{lin}", f"{f}/{attn_cls}/Dense_{idx}", has_bias)
    if noise:
        rules.append((f"{t}.attn.attn.noise_strength", f"{f}/{attn_cls}/noise_strength",
                      "copy"))
    mlp_idx = 1 if cond else 0
    rules += _dense_rules(f"{t}.mlp.fc1", f"{f}/Mlp_{mlp_idx}/Dense_0")
    rules += _dense_rules(f"{t}.mlp.fc2", f"{f}/Mlp_{mlp_idx}/Dense_1")
    if cond:
        rules += _dense_rules(f"{t}.ab.fc1", f"{f}/Mlp_0/Dense_0")
        rules += _dense_rules(f"{t}.ab.fc2", f"{f}/Mlp_0/Dense_1")
    return rules


def _multiblocks_rules(t: str, f: str, depth: int, block_type: str,
                       norm_layer: str, noise: bool = False) -> List[Rule]:
    rules: List[Rule] = []
    for i in range(depth):
        rules += _block_rules(f"{t}.multi_blocks.{i}", f"{f}/Block_{i}", block_type,
                              norm_layer, noise)
    return rules


def _patch_proj_rules(t: str, f: str, patch_size: int, from_patch: bool,
                      norm_layer_patch: str) -> List[Rule]:
    """ConvPatchProj."""
    num_dims = int(math.log2(patch_size))
    rules: List[Rule] = []
    if from_patch:
        # proj -> Conv_0; layers: (num_dims-2) Sequentials -> _ConvBlock_i,
        # the last plain conv -> Conv_1
        rules.append((f"{t}.proj.weight", f"{f}/Conv_0/kernel", "conv"))
        n_inner = num_dims - 2
        for i in range(n_inner):
            rules.append((f"{t}.layers.{i}.0.weight", f"{f}/_ConvBlock_{i}/Conv_0/kernel",
                          "conv"))
            rules += _norm_rules(f"{t}.layers.{i}.1", f"{f}/_ConvBlock_{i}/CustomNorm_0",
                                 norm_layer_patch)
        rules.append((f"{t}.layers.{n_inner}.weight", f"{f}/Conv_1/kernel", "conv"))
    else:
        # layers: (num_dims-1) Sequentials -> _ConvBlock_i, proj (deconv)
        for i in range(num_dims - 1):
            rules.append((f"{t}.layers.{i}.0.weight",
                          f"{f}/_ConvBlock_{i}/ConvTranspose_0/kernel", "deconv"))
            rules += _norm_rules(f"{t}.layers.{i}.1", f"{f}/_ConvBlock_{i}/CustomNorm_0",
                                 norm_layer_patch)
        rules.append((f"{t}.proj.weight", f"{f}/proj/kernel", "deconv"))
    return rules


# ---------------------------------------------------------------------------
# per-net rule tables
# ---------------------------------------------------------------------------


def lvd_rules(cfg) -> List[Rule]:
    """LVD (the reference's models/nets/lvd.py)."""
    m = cfg.model
    nl, nlp = m.norm_layer, m.norm_layer_patch
    rules: List[Rule] = []
    rules += _patch_proj_rules("encoder.from_img", "encoder/ConvPatchProj_0",
                               m.patch_size, True, nlp)
    le = "layer_estimator"
    if m.decompose_embed_oe:
        rules += [(f"{le}.obj_spatial_embed", f"{le}/obj_spatial_embed", "copy"),
                  (f"{le}.obj_num_embed", f"{le}/obj_num_embed", "copy")]
    else:
        rules.append((f"{le}.obj_embed", f"{le}/obj_embed", "copy"))
    rules += [(f"{le}.time_embed", f"{le}/time_embed", "copy"),
              (f"{le}.pos_embed", f"{le}/pos_embed", "copy")]
    rules += _norm_rules(f"{le}.norm", f"{le}/CustomNorm_0", nl)
    rules += _multiblocks_rules(f"{le}.blocks", f"{le}/MultiBlocks_0", m.oe_depth, "obj", nl)
    if m.pred_cls:
        rules += _norm_rules(f"{le}.cls_norm", f"{le}/CustomNorm_1", nl)
        rules += _dense_rules(f"{le}.cls_head", f"{le}/Dense_0")
    pe = "pose_estimator"
    rules += [(f"{pe}.obj_embed", f"{pe}/obj_embed", "copy"),
              (f"{pe}.pos_embed", f"{pe}/pos_embed", "copy")]
    rules += _multiblocks_rules(f"{pe}.blocks", f"{pe}/MultiBlocks_0", m.pe_depth, "full", nl)
    rules += _norm_rules(f"{pe}.norm", f"{pe}/CustomNorm_0", nl)
    rules += _dense_rules(f"{pe}.head", f"{pe}/Dense_0")
    rules += _norm_rules("decoder.norm", "decoder/CustomNorm_0", nl)
    rules += _patch_proj_rules("decoder.to_img", "decoder/ConvPatchProj_0",
                               m.patch_size, False, nlp)
    return rules


def flp_rules(cfg) -> List[Rule]:
    """FLP (the reference's models/nets/flp.py)."""
    m = cfg.model
    nl = m.norm_layer
    rules: List[Rule] = []
    rules.append(("compress.cls_embed", "compress/cls_embed", "copy"))
    rules += _norm_rules("compress.norm", "compress/CustomNorm_0", nl)
    rules += _multiblocks_rules("compress.blocks", "compress/MultiBlocks_0",
                                m.pg_com_depth, "cls", nl)
    rules += [("encode.lay_embed", "encode/lay_embed", "copy"),
              ("encode.time_embed", "encode/time_embed", "copy")]
    rules += _dense_rules("encode.to_obj_emb", "encode/Dense_0")
    rules += _dense_rules("encode.to_bg_emb", "encode/Dense_1")
    rules += _multiblocks_rules("encode.blocks", "encode/MultiBlocks_0",
                                m.pg_enc_depth, "full", nl)
    rules += _norm_rules("encode.norm", "encode/CustomNorm_0", nl)
    # the decoder's self and cross blocks interleave: Block_{2i}, Block_{2i+1}
    self_type = "full_with_cond_norm" if m.pg_modulate_noise else "full"
    self_norm = "ln_not_affine" if m.pg_modulate_noise else nl
    for i in range(m.pg_dec_depth):
        rules += _block_rules(f"decode.self_blocks.{i}", f"decode/Block_{2 * i}",
                              self_type, self_norm, noise=m.pg_inject_noise)
        rules += _block_rules(f"decode.cross_blocks.{i}", f"decode/Block_{2 * i + 1}",
                              "cross", nl)
    rules += _norm_rules("decode.norm", "decode/CustomNorm_0", nl)
    rules += _dense_rules("decode.obj_head", "decode/Dense_0")
    rules += _dense_rules("decode.bg_head", "decode/Dense_1")
    return rules


def wif_rules(cfg) -> List[Rule]:
    """WIF's UNet (the reference's models/nets/wif.py)."""
    m = cfg.model
    nlp = m.norm_layer_patch
    d = m.ii_depth
    rules: List[Rule] = [
        ("unet.to_emb.weight", "UNet_0/Conv_0/kernel", "conv"),
        ("unet.from_emb.weight", "UNet_0/Conv_1/kernel", "conv"),
    ]
    for i in range(d):
        rules.append((f"unet.conv_layers.{i}.0.weight",
                      f"UNet_0/_ConvBlock_{i}/Conv_0/kernel", "conv"))
        rules += _norm_rules(f"unet.conv_layers.{i}.1",
                             f"UNet_0/_ConvBlock_{i}/CustomNorm_0", nlp)
    # flax applies the deconvs in reverse: _ConvBlock_{d+i} is deconv_layers[d-1-i]
    for i in range(d):
        j = d - 1 - i
        rules.append((f"unet.deconv_layers.{j}.0.weight",
                      f"UNet_0/_ConvBlock_{d + i}/ConvTranspose_0/kernel", "deconv"))
        rules += _norm_rules(f"unet.deconv_layers.{j}.1",
                             f"UNet_0/_ConvBlock_{d + i}/CustomNorm_0", nlp)
    return rules


_RULES = {"pe": lvd_rules, "pg": flp_rules, "ii": wif_rules}


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def _convert_leaf(arr: np.ndarray, kind: str) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if kind == "dense":
        return np.ascontiguousarray(arr.T)
    if kind == "conv":  # (O,I,kh,kw) -> (kh,kw,I,O)
        return np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
    if kind == "deconv":  # (I,O,kh,kw) -> flipped (kh,kw,I,O)
        return np.ascontiguousarray(arr.transpose(2, 3, 0, 1)[::-1, ::-1])
    return arr


def strip_ddp_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DistributedDataParallel's "module." prefix."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def _flat_shapes(tree, prefix=()) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = tuple(np.shape(v))
    return out


def convert_net(sd: Dict[str, np.ndarray], rules: List[Rule],
                template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Apply a rule table to a torch state dict -> flax params tree (nested
    dicts of numpy arrays); with ``template`` (a flax tree) the paths and
    shapes must agree."""
    tree: Dict[str, Any] = {}
    for tkey, fpath, kind in rules:
        if tkey not in sd:
            raise KeyError(f"checkpoint missing {tkey!r} (wanted for {fpath})")
        leaf = _convert_leaf(np.asarray(sd[tkey]), kind)
        node = tree
        parts = fpath.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    if template is not None:
        t_paths, c_paths = _flat_shapes(template), _flat_shapes(tree)
        missing = sorted(set(t_paths) - set(c_paths))
        extra = sorted(set(c_paths) - set(t_paths))
        if missing or extra:
            raise ValueError(f"param-tree mismatch: missing={missing[:8]} extra={extra[:8]}")
        for p, shape in t_paths.items():
            if c_paths[p] != shape:
                raise ValueError(f"shape mismatch at {p}: got {c_paths[p]}, want {shape}")
    return tree


# ---------------------------------------------------------------------------
# buffer verification (constants the nets recompute instead of loading)
# ---------------------------------------------------------------------------

_BUFFER_PAT = re.compile(
    r"(\.|^)(bias|mul|tgt_pts|tgt_pts_bg|occ_bias|min_bound|max_bound|bg_bias|"
    r"diag|bg_alpha|obj_alpha_mask|src_pts|src_grid|src_grid_hd|tgt_grid|"
    r"causal_mask|time_proj|grid|ones)$")


def expected_buffers(cfg, net: str) -> Dict[str, np.ndarray]:
    """The reference's buffers that the nets recompute; checked, never
    loaded."""
    from ..ops.grid import get_grid
    from .lvd import _obj_bias_and_mul, bg_alpha_buffer, obj_alpha_border_mask

    m = cfg.model
    lo = m.obj_shape[0] * m.obj_shape[1]
    l = m.latent_shape[0] * m.latent_shape[1]
    ar = cfg.aspect_ratio
    out: Dict[str, np.ndarray] = {}
    if net == "pe":
        bias, mul = _obj_bias_and_mul(m, ar)
        out["pose_estimator.bias"] = np.asarray(bias).reshape(1, -1, 1, 8)
        out["pose_estimator.mul"] = np.asarray(mul).reshape(1, 1, 1, 8)
        out["pose_estimator.tgt_pts"] = np.asarray(get_grid(*m.obj_shape)).reshape(1, 1, lo, 2)
        out["pose_estimator.occ_bias"] = np.asarray(
            [[2.0 * i for i in range(m.num_obj)]], np.float32)
        if m.bound_rest:
            out["pose_estimator.min_bound"] = np.asarray(
                [[[0, 0, m.min_scale_bound, 0, 0, ar * m.min_scale_bound,
                   -m.max_translate_bound, -m.max_translate_bound]]], np.float32)
            out["pose_estimator.max_bound"] = np.asarray(
                [[[0, 0, m.max_scale_bound, 0, 0, ar * m.max_scale_bound,
                   m.max_translate_bound, m.max_translate_bound]]], np.float32)
        if m.has_bg:
            out["pose_estimator.bg_bias"] = np.asarray([[[[0, 0, 1, 0, 0, 1, 0, 0]]]],
                                                       np.float32)
            out["pose_estimator.tgt_pts_bg"] = np.asarray(
                get_grid(*m.latent_shape)).reshape(1, 1, l, 2)
        # compared in flat order only (verify_buffers reshapes to -1)
        out["bg_alpha"] = np.asarray(bg_alpha_buffer(cfg))
        mask = obj_alpha_border_mask(cfg)
        if mask is not None:
            out["obj_alpha_mask"] = np.asarray(mask)
        out["diag"] = np.eye(m.num_obj, dtype=np.float32)[None, None]
    elif net == "pg":
        if m.unconstrained_pose_decoder:
            init_scale, mul_scale = 1.0, 1.0
        else:
            init_scale, mul_scale = m.init_scale_obj, m.mul_scale_obj
        out["decode.tgt_pts_obj"] = np.asarray(get_grid(*m.obj_shape)).reshape(1, 1, lo, 2)
        out["decode.tgt_pts_bg"] = np.asarray(get_grid(*m.latent_shape)).reshape(1, 1, l, 2)
        out["decode.mul_obj"] = np.asarray([[[mul_scale] * 4 + [1.0, 1.0]]], np.float32)
        if not m.use_last_pose_decoder:
            out["decode.bias_obj"] = np.asarray(
                [[[init_scale, 0, 0, ar * init_scale, 0, 0]]], np.float32)
            out["decode.bias_bg"] = np.asarray([[[1, 0, 0, 1, 0, 0]]], np.float32)
    return out


def verify_buffers(sd: Dict[str, np.ndarray], cfg, net: str,
                   atol: float = 1e-5) -> List[str]:
    """Check the checkpoint's buffers against the recomputed constants.

    Returns the buffer keys present in ``sd`` that are neither loaded nor
    verified (the warper's grids and the like: geometry recomputed from the
    shapes). Raises on a verified buffer whose value differs."""
    expected = expected_buffers(cfg, net)
    unverified = []
    for key, want in expected.items():
        if key not in sd:
            continue
        got = np.asarray(sd[key], np.float32).reshape(-1)
        want = np.asarray(want, np.float32).reshape(-1)
        if got.shape != want.shape or not np.allclose(got, want, atol=atol):
            raise ValueError(
                f"checkpoint buffer {key!r} does not match the constant the nets recompute "
                f"(e.g. rd_translate_bias runs are not convertible); max err "
                f"{np.abs(got - want).max() if got.shape == want.shape else 'shape'}")
    for key in sd:
        if key not in expected and _BUFFER_PAT.search(key):
            unverified.append(key)
    return unverified


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference .pth (torch serialization of a state dict) as numpy
    arrays, without DDP's prefix."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in strip_ddp_prefix(sd).items()}


def convert_reference_net(sd: Dict[str, np.ndarray], cfg, net: str,
                          template: Optional[Dict[str, Any]] = None,
                          check_buffers: bool = True) -> Dict[str, Any]:
    """One torch state dict -> the flax params tree of net 'pe', 'pg' or
    'ii'."""
    sd = strip_ddp_prefix({k: np.asarray(v) for k, v in sd.items()})
    if check_buffers:
        verify_buffers(sd, cfg, net)
    return convert_net(sd, _RULES[net](cfg), template=template)


def _checkpoint_path(ckpt_dir: str, label: str, which_iter) -> Optional[str]:
    paths = glob(os.path.join(ckpt_dir, f"{label}_*net_{which_iter}.pth"))
    return paths[0] if paths else None


def convert_reference_checkpoints(ckpt_dir: str, which_iter, cfg,
                                  templates: Optional[Dict[str, Any]] = None
                                  ) -> Dict[str, Any]:
    """The ``{label}_net_{iter}.pth`` files of a reference run directory ->
    {'pe': ..., 'pg': ..., 'ii': ...} flax trees; a label without a file is
    skipped (the reference trains the nets in separate runs)."""
    out: Dict[str, Any] = {}
    for label in ("pe", "pg", "ii"):
        path = _checkpoint_path(ckpt_dir, label, which_iter)
        if path is None:
            continue
        sd = load_torch_state_dict(path)
        template = (templates or {}).get(label)
        out[label] = convert_reference_net(sd, cfg, label, template=template)
    return out


def load_reference_checkpoints(syn, ckpt_dir: str, which_iter) -> None:
    """Fill a port ``Synthesizer``'s nets from the reference's checkpoints
    in ``ckpt_dir`` at ``which_iter``, strictly: every net the synthesizer
    holds needs its file, and a checkpoint key that no rule takes and that
    is no known buffer, a net parameter that no key fills, or a shape that
    disagrees raises (``convert.from_jax``)."""
    from ..convert import from_jax, to_jax

    trees = {}
    for label in syn.nets():
        if label == "id":  # the reference ships no discriminator: it keeps its own
            trees[label] = to_jax(syn)[label]
            continue
        path = _checkpoint_path(ckpt_dir, label, which_iter)
        if path is None:
            raise FileNotFoundError(f"no {label}_*net_{which_iter}.pth in {ckpt_dir}")
        sd = load_torch_state_dict(path)
        rules = _RULES[label](syn.cfg)
        unused = sorted(set(sd) - {r[0] for r in rules} - set(expected_buffers(syn.cfg, label))
                        - set(verify_buffers(sd, syn.cfg, label)))
        if unused:
            raise ValueError(f"{path} has keys no rule takes: {unused[:8]}")
        trees[label] = {"params": convert_net(sd, rules)}
    from_jax(trees, syn)
