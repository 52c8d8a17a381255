"""JAX parameter trees -> the port's modules.

``from_jax(params_np, synthesizer)`` takes the JAX package's parameter tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` of
``Synthesizer.init_params``: keys "pe", "pg", "ii" and, with the GAN, "id",
each optionally under a "params" collection) and loads it into the
synthesizer's ``lvd``, ``flp``, ``wif`` and ``disc`` modules. It is strict: a leaf of the tree that no port parameter
takes, a port parameter that no leaf fills, or a shape that disagrees
raises.

Layout rules (the inverse of waldo_tpu/models/convert.py):
  dense  flax kernel (I, O)          -> torch (O, I)
  conv   flax kernel (kh, kw, I, O)  -> torch (O, I, kh, kw)
  deconv flax kernel (kh, kw, I, O)  -> torch (I, O, kh, kw), spatially
         flipped: the JAX transposed conv correlates its kernel as given,
         torch's ConvTranspose2d the flipped one
  copy   identical shapes (embeddings, norm scale/bias, noise_strength)

``load_from_jax(tree_np, module, rules, what)`` loads one module by a rule
list (``attention_rules``, ``block_rules``, ``disc_rules``); the
discriminator's ("id") are its convolutions ``Conv_0..4`` (kernel and bias)
and per-channel norms ``CustomNorm_0..2``.

``to_jax(synthesizer, grads=False)`` is the inverse: the nets' parameters,
or their gradients, as the JAX package's tree (the gradient tests and the
checkpoints use it).

``inception_from_jax(tree_np, module)`` and ``i3d_from_jax(tree_np,
module)`` load the JAX package's FID and FVD extractors (eval/inception.py,
eval/i3d.py), whose leaves "a/b/conv/kernel" (kh,kw,I,O) and
"a/b/conv3d/kernel" (kt,kh,kw,I,O) fill the port's "a.b.conv.weight"
(O,I,kh,kw) and "a.b.conv3d.weight" (O,I,kt,kh,kw), biases as they are;
``vgg19_from_jax(tree_np, module)`` the perceptual loss's VGG19Features
(nn/perceptual.py) the same way, "conv{i}/kernel" to "conv{i}.weight".

``mat_from_jax(variables_np, module)`` does the same for the MAT
``Generator`` (models/mat) or any of its modules, which carry the flax
names: the leaf "a/b/weight" of the ``params`` collection fills the port's
"a.b.weight" (dense (I, O) and conv (kh, kw, I, O) kernels in the layouts
above; a layer built with ``use_bias=False`` has no "bias" on either side),
the ``noise_const`` leaf "a/b/n" fills the buffer "a.b.noise_const"
and the ``w_stats`` leaf "mapping/w_avg" the buffer "mapping.w_avg".
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# rule: (port state_dict key, flax path "a/b/c", kind)
Rule = Tuple[str, str, str]

_ATTN_CLS = {"full": "FullAttention_0", "full_with_cond_norm": "FullAttention_0",
             "cross": "CrossAttention_0", "obj": "ObjAttention_0", "cls": "ClsAttention_0",
             "ctx": "CtxAttention_0", "seed": "SeedAttention_0",
             "block_causal": "BlockCausalAttention_0", "skip": "SkipAttention_0",
             "skip2": "Skip2Attention_0"}
_Q_KV = [("q", 0, False), ("kv", 1, False), ("proj", 2, True)]
_SKIP = [("qkv", 0, False), ("k_ctx", 1, False), ("v_ctx", 2, False), ("proj", 3, True)]
# port linear name -> flax Dense index, has_bias
_ATTN_LINS = {
    "full": [("qkv", 0, False), ("proj", 1, True)],
    "cross": _Q_KV, "obj": _Q_KV, "cls": _Q_KV, "ctx": _Q_KV,
    "seed": [("qkv", 0, False), ("kv_cls", 1, False), ("proj", 2, True)],
    "block_causal": [("qkv", 0, False), ("proj", 1, True)],
    "skip": _SKIP, "skip2": _SKIP,
}
_ATTN_LINS["full_with_cond_norm"] = _ATTN_LINS["full"]


def _join(prefix: str, name: str, sep: str) -> str:
    return f"{prefix}{sep}{name}" if prefix else name


def _norm(t: str, f: str, norm_layer: str) -> List[Rule]:
    sub = {"ln": "LayerNorm_0", "ln2d": "GroupNorm_0"}.get(norm_layer)
    if sub is None:
        return []
    return [(f"{t}.weight", f"{f}/{sub}/scale", "copy"),
            (f"{t}.bias", f"{f}/{sub}/bias", "copy")]


def _dense(t: str, f: str, has_bias: bool = True) -> List[Rule]:
    rules = [(f"{t}.weight", f"{f}/kernel", "dense")]
    if has_bias:
        rules.append((f"{t}.bias", f"{f}/bias", "copy"))
    return rules


def attention_rules(block_type: str, t: str = "", f: str = "", noise: bool = False) -> List[Rule]:
    """The rules of an attention module of ``block_type`` at the port path
    ``t`` and the flax path ``f`` (both empty: the module itself)."""
    rules: List[Rule] = []
    for lin, idx, has_bias in _ATTN_LINS[block_type]:
        rules += _dense(_join(t, lin, "."), _join(f, f"Dense_{idx}", "/"), has_bias)
    if noise:
        rules.append((_join(t, "noise_strength", "."), _join(f, "noise_strength", "/"), "copy"))
    return rules


def _block(t: str, f: str, block_type: str, norm_layer: str, noise: bool = False) -> List[Rule]:
    rules = _norm(f"{t}.norm1", f"{f}/CustomNorm_0", norm_layer)
    rules += _norm(f"{t}.norm2", f"{f}/CustomNorm_1", norm_layer)
    rules += attention_rules(block_type, f"{t}.attn", f"{f}/{_ATTN_CLS[block_type]}", noise)
    mlp = 0
    if block_type == "full_with_cond_norm":  # the conditioning Mlp is built first
        rules += _dense(f"{t}.cond.fc1", f"{f}/Mlp_0/Dense_0")
        rules += _dense(f"{t}.cond.fc2", f"{f}/Mlp_0/Dense_1")
        mlp = 1
    rules += _dense(f"{t}.mlp.fc1", f"{f}/Mlp_{mlp}/Dense_0")
    rules += _dense(f"{t}.mlp.fc2", f"{f}/Mlp_{mlp}/Dense_1")
    return rules


def block_rules(block_type: str, norm_layer: str, noise: bool = False) -> List[Rule]:
    """The rules of one ``nn.Block`` (the module itself)."""
    return [(k[1:], f[1:], kind) for k, f, kind in _block("", "", block_type, norm_layer, noise)]


def _multiblocks(t: str, f: str, depth: int, block_type: str, norm_layer: str) -> List[Rule]:
    rules: List[Rule] = []
    for i in range(depth):
        rules += _block(f"{t}.layers.{i}", f"{f}/Block_{i}", block_type, norm_layer)
    return rules



def _conv_block(t: str, f: str, mode: str, norm_layer: str) -> List[Rule]:
    conv = "Conv_0" if mode == "conv" else "ConvTranspose_0"
    kind = "conv" if mode == "conv" else "deconv"
    return ([(f"{t}.conv.weight", f"{f}/{conv}/kernel", kind)]
            + _norm(f"{t}.norm", f"{f}/CustomNorm_0", norm_layer))


def _patch_proj(t: str, f: str, patch_size: int, from_patch: bool, norm_layer: str) -> List[Rule]:
    num_dims = int(math.log2(patch_size))
    if from_patch:
        rules = [(f"{t}.conv_in.weight", f"{f}/Conv_0/kernel", "conv")]
        for i in range(num_dims - 2):
            rules += _conv_block(f"{t}.blocks.{i}", f"{f}/_ConvBlock_{i}", "conv", norm_layer)
        return rules + [(f"{t}.conv_out.weight", f"{f}/Conv_1/kernel", "conv")]
    rules = []
    for i in range(num_dims - 1):
        rules += _conv_block(f"{t}.blocks.{i}", f"{f}/_ConvBlock_{i}", "deconv", norm_layer)
    return rules + [(f"{t}.proj.weight", f"{f}/proj/kernel", "deconv")]


def lvd_rules(cfg) -> List[Rule]:
    m = cfg.model
    nl, nlp = m.norm_layer, m.norm_layer_patch
    rules = _patch_proj("encoder.proj", "encoder/ConvPatchProj_0", m.patch_size, True, nlp)
    le = "layer_estimator"
    embeds = (["obj_spatial_embed", "obj_num_embed"] if m.decompose_embed_oe else ["obj_embed"])
    rules += [(f"{le}.{e}", f"{le}/{e}", "copy") for e in embeds + ["time_embed", "pos_embed"]]
    rules += _norm(f"{le}.norm", f"{le}/CustomNorm_0", nl)
    rules += _multiblocks(f"{le}.blocks", f"{le}/MultiBlocks_0", m.oe_depth, "obj", nl)
    if m.pred_cls:
        rules += _norm(f"{le}.cls_norm", f"{le}/CustomNorm_1", nl)
        rules += _dense(f"{le}.cls_head", f"{le}/Dense_0")
    pe = "pose_estimator"
    rules += [(f"{pe}.obj_embed", f"{pe}/obj_embed", "copy"),
              (f"{pe}.pos_embed", f"{pe}/pos_embed", "copy")]
    rules += _multiblocks(f"{pe}.blocks", f"{pe}/MultiBlocks_0", m.pe_depth, "full", nl)
    rules += _norm(f"{pe}.norm", f"{pe}/CustomNorm_0", nl)
    rules += _dense(f"{pe}.head", f"{pe}/Dense_0")
    rules += _norm("decoder.norm", "decoder/CustomNorm_0", nl)
    rules += _patch_proj("decoder.proj", "decoder/ConvPatchProj_0", m.patch_size, False, nlp)
    return rules


def flp_rules(cfg) -> List[Rule]:
    m = cfg.model
    nl = m.norm_layer
    rules: List[Rule] = [("compress.cls_embed", "compress/cls_embed", "copy")]
    rules += _norm("compress.norm", "compress/CustomNorm_0", nl)
    rules += _multiblocks("compress.blocks", "compress/MultiBlocks_0", m.pg_com_depth, "cls", nl)
    rules += [("encode.lay_embed", "encode/lay_embed", "copy"),
              ("encode.time_embed", "encode/time_embed", "copy")]
    rules += _dense("encode.to_obj_emb", "encode/Dense_0")
    rules += _dense("encode.to_bg_emb", "encode/Dense_1")
    rules += _multiblocks("encode.blocks", "encode/MultiBlocks_0", m.pg_enc_depth, "full", nl)
    rules += _norm("encode.norm", "encode/CustomNorm_0", nl)
    for i in range(m.pg_dec_depth):
        rules += _block(f"decode.self_blocks.{i}", f"decode/Block_{2 * i}", "full", nl,
                        noise=m.pg_inject_noise)
        rules += _block(f"decode.cross_blocks.{i}", f"decode/Block_{2 * i + 1}", "cross", nl)
    rules += _norm("decode.norm", "decode/CustomNorm_0", nl)
    rules += _dense("decode.obj_head", "decode/Dense_0")
    rules += _dense("decode.bg_head", "decode/Dense_1")
    return rules


def wif_rules(cfg) -> List[Rule]:
    m = cfg.model
    nlp, d = m.norm_layer_patch, m.ii_depth
    rules: List[Rule] = [("unet.to_emb.weight", "UNet_0/Conv_0/kernel", "conv"),
                         ("unet.from_emb.weight", "UNet_0/Conv_1/kernel", "conv")]
    for i in range(d):
        rules += _conv_block(f"unet.conv_layers.{i}", f"UNet_0/_ConvBlock_{i}", "conv", nlp)
        rules += _conv_block(f"unet.deconv_layers.{i}", f"UNet_0/_ConvBlock_{d + i}",
                             "deconv", nlp)
    return rules


def disc_rules(cfg=None, depth: int = 4) -> List[Rule]:
    """The discriminator ("id"): Conv_0..Conv_depth with biases, and the
    per-channel norms CustomNorm_0..depth-2 after the middle convs."""
    rules: List[Rule] = []
    for i in range(depth + 1):
        rules += [(f"convs.{i}.weight", f"Conv_{i}/kernel", "conv"),
                  (f"convs.{i}.bias", f"Conv_{i}/bias", "copy")]
    for i in range(depth - 1):
        rules += _norm(f"norms.{i}", f"CustomNorm_{i}", "ln2d")
    return rules


def wif_jax_leaf_order(cfg) -> List[str]:
    """WIF's flax paths in the order ``jax.tree_util.tree_flatten`` visits
    them: dict keys sorted at every level, so "_ConvBlock_10" comes before
    "_ConvBlock_2"."""
    return sorted((f for _, f, _ in wif_rules(cfg)), key=lambda f: f.split("/"))


def wif_port_key(cfg, flax_path: str) -> str:
    """The port's WIF parameter name of a flax path."""
    for key, f, _ in wif_rules(cfg):
        if f == flax_path:
            return key
    raise KeyError(f"WIF has no flax leaf {flax_path!r}")


_RULES = {"pe": lvd_rules, "pg": flp_rules, "ii": wif_rules, "id": disc_rules}


def _convert_leaf(arr: np.ndarray, kind: str) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if kind == "dense":
        return arr.T
    if kind == "conv":  # (kh,kw,I,O) -> (O,I,kh,kw)
        return arr.transpose(3, 2, 0, 1)
    if kind == "deconv":  # (kh,kw,I,O) -> flipped (I,O,kh,kw)
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _net_state_dict(module: torch.nn.Module, tree, rules: List[Rule], net: str):
    if set(tree) == {"params"}:
        tree = tree["params"]
    leaves = _flatten(tree)
    own = module.state_dict()
    new = {}
    for key, fpath, kind in rules:
        if fpath not in leaves:
            raise KeyError(f"JAX tree {net!r} has no leaf {fpath!r} (wanted for {key})")
        if key not in own:
            raise KeyError(f"port module {net!r} has no parameter {key!r} (for {fpath})")
        arr = _convert_leaf(leaves.pop(fpath), kind)
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{net}: {fpath} {arr.shape} does not fit {key} "
                             f"{tuple(own[key].shape)}")
        new[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if leaves:
        raise ValueError(f"JAX tree {net!r} has leaves no port parameter takes: "
                         f"{sorted(leaves)[:8]}")
    unfilled = sorted(set(own) - set(new))
    if unfilled:
        raise ValueError(f"port module {net!r} has parameters no leaf fills: {unfilled[:8]}")
    return new


def load_from_jax(tree_np, module: torch.nn.Module, rules: List[Rule], what: str) -> None:
    """Load a flax tree (nested dicts of numpy arrays, optionally under
    "params") into ``module`` by ``rules`` (``attention_rules``,
    ``block_rules``, ...), strictly."""
    module.load_state_dict(_net_state_dict(module, tree_np, rules, what), strict=True)


def from_jax(params_np, synthesizer) -> None:
    """Load a JAX parameter tree (nested dicts of numpy arrays) into the
    synthesizer's nets, strictly (see the module docstring)."""
    nets = synthesizer.nets()
    extra = sorted(set(params_np) - set(nets))
    if extra:
        raise ValueError(f"JAX tree has nets the port does not hold: {extra}")
    for net, module in nets.items():
        if net not in params_np:
            raise KeyError(f"JAX tree has no {net!r} parameters")
        sd = _net_state_dict(module, params_np[net], _RULES[net](synthesizer.cfg), net)
        module.load_state_dict(sd, strict=True)


def _mat_leaf(collection: str, path: str, arr) -> Tuple[str, np.ndarray]:
    parts = path.split("/")
    if collection == "noise_const":
        if parts[-1] != "n":
            raise ValueError(f"unexpected noise_const leaf {path!r}")
        parts[-1] = "noise_const"
    kind = "copy"
    if collection == "params" and parts[-1] == "weight":
        kind = {2: "dense", 4: "conv"}.get(np.ndim(arr), "copy")
    return ".".join(parts), _convert_leaf(arr, kind)


def mat_from_jax(variables_np, module: torch.nn.Module) -> None:
    """Load the flax variables of the JAX package's MAT ``Generator``, or of
    any of its submodules (``params``, ``noise_const``, ``w_stats``; nested
    dicts of numpy arrays), into the port's module of the same name,
    strictly (see the module docstring)."""
    extra = sorted(set(variables_np) - {"params", "noise_const", "w_stats"})
    if extra:
        raise ValueError(f"MAT variables have collections the port does not hold: {extra}")
    own = module.state_dict()
    new = {}
    for collection, tree in variables_np.items():
        for path, arr in _flatten(tree).items():
            key, value = _mat_leaf(collection, path, arr)
            if key not in own:
                raise ValueError(f"MAT leaf {collection}/{path} has no port entry {key!r}")
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(f"MAT leaf {collection}/{path} {value.shape} does not fit "
                                 f"{key} {tuple(own[key].shape)}")
            new[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    unfilled = sorted(set(own) - set(new))
    if unfilled:
        raise ValueError(f"port MAT module has entries no leaf fills: {unfilled[:8]}")
    module.load_state_dict(new, strict=True)


def _conv_from_jax(tree_np, module: torch.nn.Module, what: str) -> None:
    """Load a flax tree of convolutions (kernels channel-last, any rank)
    into the module of the same names, strictly."""
    if set(tree_np) == {"params"}:
        tree_np = tree_np["params"]
    own = module.state_dict()
    new = {}
    for path, arr in _flatten(tree_np).items():
        *parents, leaf = path.split("/")
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":  # (k..., I, O) -> (O, I, k...)
            leaf, arr = "weight", arr.transpose((arr.ndim - 1, arr.ndim - 2)
                                                + tuple(range(arr.ndim - 2)))
        key = ".".join(parents + [leaf])
        if key not in own:
            raise ValueError(f"{what} leaf {path} has no port entry {key!r}")
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{what} leaf {path} {arr.shape} does not fit {key} "
                             f"{tuple(own[key].shape)}")
        new[key] = torch.from_numpy(np.ascontiguousarray(arr))
    unfilled = sorted(set(own) - set(new))
    if unfilled:
        raise ValueError(f"port {what} has entries no leaf fills: {unfilled[:8]}")
    module.load_state_dict(new, strict=True)


def vgg19_from_jax(tree_np, module: torch.nn.Module) -> None:
    """Load the JAX package's VGG19Features tree (``conv{i}`` kernels and
    biases, with or without its "params" collection) into the port's
    ``nn.perceptual.VGG19Features``, strictly."""
    _conv_from_jax(tree_np, module, "VGG19")


def inception_from_jax(tree_np, module: torch.nn.Module) -> None:
    """Load the JAX package's InceptionV3Features tree (nested dicts of
    numpy arrays, with or without its "params" collection) into the port's
    ``eval.inception.InceptionV3Features``, strictly."""
    _conv_from_jax(tree_np, module, "Inception")


def i3d_from_jax(tree_np, module: torch.nn.Module) -> None:
    """Load the JAX package's I3D tree into the port's ``eval.i3d.I3D``,
    strictly."""
    _conv_from_jax(tree_np, module, "I3D")


def _unconvert_leaf(arr: np.ndarray, kind: str) -> np.ndarray:
    """The inverse of ``_convert_leaf``: a port layout back to flax's."""
    if kind == "dense":
        return arr.T
    if kind == "conv":  # (O,I,kh,kw) -> (kh,kw,I,O)
        return arr.transpose(2, 3, 1, 0)
    if kind == "deconv":  # flipped (I,O,kh,kw) -> (kh,kw,I,O)
        return arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    return arr


def to_jax(synthesizer, grads: bool = False) -> Dict[str, dict]:
    """The inverse of ``from_jax``: the synthesizer's nets as the JAX
    package's parameter tree, nested dicts of float32 numpy arrays under
    "pe", "pg", "ii", each under a "params" collection. With ``grads`` the
    leaves are the parameters' ``.grad`` (zeros where a parameter has
    none), in the same layout."""
    out = {}
    for net, module in synthesizer.nets().items():
        own = dict(module.named_parameters())
        tree: dict = {}
        for key, fpath, kind in _RULES[net](synthesizer.cfg):
            p = own[key]
            t = p.grad if grads else p
            # a copy: a CPU tensor's numpy() shares the parameter's memory
            arr = np.zeros(tuple(p.shape), np.float32) if t is None else \
                np.array(t.detach().float().cpu().numpy())
            node = tree
            *parents, leaf = fpath.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(_unconvert_leaf(arr, kind))
        out[net] = {"params": tree}
    return out
