"""LVD, the layered video decomposition network (counterpart of
waldo_tpu/models/lvd.py).

The learned parts (encoder, layer estimator, pose estimator, alpha decoder)
are ``nn.Module``s under ``LVDNet``; the parameterless geometry lives in
``Warper`` (warper.py).

Channel-last layouts:
  input video   (B, T, H, W, C)        tokens x       (B, T, L, C)
  x_obj         (B, No, Lo, C)         x_bg           (B, L, C)
  obj_pose      (B, T, No, Lo, 2)      bg_pose        (B, T, 1, L, 2)
  occ_score     (B, T, No)             obj_alpha      (B, No, Ho, Wo, 1)

Sequence sharding (parallel/sharding.py) where the JAX package shards: with
``shard_seq`` set (``Synthesizer.shard_sequence``), the pose estimator's
token stream and the layer estimator's context tokens are split over the
seq ranks; the pose estimator gathers its stream after its stack.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..nn import ConvPatchProj, CustomNorm, Dense, MultiBlocks
from ..nn.init import trunc_normal_
from ..ops import get_circle, get_grid, resize
from ..parallel.sharding import token_shard


def get_num_channels(dtype: str, num_lyt: int) -> int:
    """Channel count from a modality string."""
    n = 0
    if "A" in dtype:
        n += 1
    if "L" in dtype:
        n += num_lyt
    if "M" in dtype:
        n += 1
    if "S" in dtype:
        n += 2
    if "RGB" in dtype:
        n += 3
    if "F" in dtype:
        n += 2
    return n


def input_dtype_string(m) -> str:
    return ("RGB" if m.input_rgb else "") + ("L" if m.input_lyt else "") + ("F" if m.input_flow else "")


class _Embeddings(nn.Module):
    """Base for modules that own learned embedding tables (trunc-normal)."""

    _embeddings: tuple = ()

    def init_parameters(self, generator):
        for name in self._embeddings:
            trunc_normal_(getattr(self, name), generator)


class ImageEncoder(nn.Module):
    """(B,T,H,W,C) -> (B,T,L,C) tokens."""

    def __init__(self, cfg, dtype_str, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.scale = cfg.load_dim / cfg.dim if cfg.load_dim > 0 else m.scale_factor
        self.proj = ConvPatchProj(m.patch_size, m.embed_dim, m.norm_layer_patch,
                                  get_num_channels(dtype_str, cfg.data.num_lyt),
                                  from_patch=True, dtype=dtype)

    def forward(self, vid):
        lead = tuple(vid.shape[:-3])
        img = vid.reshape((-1,) + tuple(vid.shape[-3:]))
        if self.scale != 1:
            img = resize(img, 1.0 / self.scale)
        tokens = self.proj(img)
        return tokens.reshape(lead + tuple(tokens.shape[1:]))


class ImageDecoder(nn.Module):
    """Tokens -> image with a tanh alpha head."""

    def __init__(self, cfg, dtype_str="A", init_mode="", use_prior=False,
                 dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        self.dtype_str = dtype_str
        self.offset = 5.0 if init_mode == "five" else 0.0
        self.use_prior = use_prior
        self.norm = CustomNorm(m.norm_layer, m.embed_dim)
        self.proj = ConvPatchProj(m.patch_size, m.embed_dim, m.norm_layer_patch,
                                  get_num_channels(dtype_str, cfg.data.num_lyt),
                                  from_patch=False,
                                  zero_init_proj=init_mode in ("zero", "five"), dtype=dtype)

    def forward(self, x, drop_alpha=False):
        m = self.cfg.model
        lead = tuple(x.shape[:-2])
        x = x.reshape((-1,) + tuple(x.shape[-2:]))
        lat_obj = m.obj_shape[0] * m.obj_shape[1]
        lat = m.latent_shape[0] * m.latent_shape[1]
        latent_shape = {lat: m.latent_shape, lat_obj: m.obj_shape}[x.shape[1]]
        img = self.proj(self.norm(x), latent_shape=latent_shape) + self.offset
        if "A" in self.dtype_str:
            alpha = torch.tanh(img[..., -1:])
            if self.use_prior:
                h, w = img.shape[-3], img.shape[-2]
                circle = torch.as_tensor(get_circle((h, w), p=0.75)[..., None],
                                         device=img.device)
                alpha = circle * 1.0 + (1 - circle) * alpha
            img = torch.cat([img[..., :-1], alpha], dim=-1)
            if drop_alpha:
                img = img[..., :-1]
        if m.scale_factor != 1:
            img = resize(img, m.scale_factor)
        return img.reshape(lead + tuple(img.shape[1:]))


def _obj_bias_and_mul(m, aspect_ratio):
    """Per-object pose bias and multiplier tables."""
    s = m.init_scale_obj
    if m.rd_translate_bias:
        rng = np.random.RandomState(0)
        mu = m.translate_bias_mul
        rows = [[0, 0, s, 0, 0, aspect_ratio * s, mu * rng.rand(), mu * rng.rand()]
                for _ in range(m.num_obj)]
    elif m.circle_translate_bias:
        r = m.circle_translate_radius
        theta = [i * 2 * math.pi / (m.num_obj + 1) for i in range(m.num_obj)]
        rows = [[0, 0, s, 0, 0, aspect_ratio * s, r * math.cos(t), r * math.sin(t)]
                for t in theta]
    else:
        rows = [[0, 0, s, 0, 0, aspect_ratio * s, 0, 0]]
    bias = np.asarray(rows, np.float32).reshape(1, -1, 1, 8)
    mul = np.asarray(
        [m.mul_delta_obj, m.mul_delta_obj, m.mul_scale_obj, m.mul_scale_obj,
         m.mul_scale_obj, m.mul_scale_obj, 1.0, 1.0], np.float32
    ).reshape(1, 1, 1, 8)
    return bias, mul


class PoseEstimator(_Embeddings):
    """Per-frame 8-dof pose and occlusion score per object, TPS background
    pose (pts_mode 'prior')."""

    _embeddings = ("obj_embed", "pos_embed")

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        c = m.embed_dim
        lo = m.obj_shape[0] * m.obj_shape[1]
        l = m.latent_shape[0] * m.latent_shape[1]
        self.obj_embed = nn.Parameter(torch.empty(1, 1, lo, c))
        self.pos_embed = nn.Parameter(torch.empty(1, 1, l, c))
        self.blocks = MultiBlocks(m.pe_depth, c, m.num_heads, "full", m.norm_layer, dtype=dtype)
        self.shard_seq = False  # split the stack's tokens over the seq ranks
        self.norm = CustomNorm(m.norm_layer, c)
        out = 8 + (1 if m.bound_scale else 0) + 1
        self.head = Dense(c, out, dtype=dtype, zero_init=m.pe_estimator_init_mode == "zero")
        bias, mul = _obj_bias_and_mul(m, cfg.aspect_ratio)
        self.register_buffer("bias", torch.as_tensor(bias), persistent=False)
        self.register_buffer("mul", torch.as_tensor(mul), persistent=False)
        self.register_buffer("tgt_pts", torch.as_tensor(get_grid(*m.obj_shape)).reshape(1, 1, lo, 2),
                             persistent=False)
        self.register_buffer("tgt_pts_bg", torch.as_tensor(get_grid(*m.latent_shape)).reshape(1, 1, l, 2),
                             persistent=False)
        # constant rows built once here: a tensor made from a list inside
        # forward is a host-to-device copy that waits for the queued work
        ar = cfg.aspect_ratio
        self.register_buffer("min_bound", torch.tensor(
            [0, 0, m.min_scale_bound, 0, 0, ar * m.min_scale_bound,
             -m.max_translate_bound, -m.max_translate_bound]), persistent=False)
        self.register_buffer("max_bound", torch.tensor(
            [0, 0, m.max_scale_bound, 0, 0, ar * m.max_scale_bound,
             m.max_translate_bound, m.max_translate_bound]), persistent=False)
        self.register_buffer("occ_bias", torch.tensor([2.0 * i for i in range(m.num_obj)]),
                             persistent=False)
        self.register_buffer("bg_bias", torch.tensor([0.0, 0, 1, 0, 0, 1, 0, 0]), persistent=False)

    def forward(self, x, x_obj, x_bg, eps=1e-6):
        m = self.cfg.model
        b, t, l, c = x.shape
        no, lo = m.num_obj, m.obj_shape[0] * m.obj_shape[1]

        x = x + self.pos_embed
        xo = (x_obj + self.obj_embed).reshape(b, 1, no * lo, c).expand(b, t, no * lo, c)
        if m.has_bg:
            xb = (x_bg + self.pos_embed[:, 0]).reshape(b, 1, l, c).expand(b, t, l, c)
            x = torch.cat([xb, xo, x], dim=2)
        else:
            x = torch.cat([xo, x], dim=2)

        x = x.reshape(b * t, -1, c)
        tokens = token_shard(x.shape[1], self.shard_seq)
        x = tokens.gather(self.blocks(tokens.shard(x), tokens=tokens))
        keep = l + no * lo if m.has_bg else no * lo
        x = x[:, :keep]
        x_for_head = x[:, l:] if (m.has_bg and m.fix_bg) else x
        out = self.head(self.norm(x_for_head))
        p, s = 8, (1 if m.bound_scale else 0)
        pose, scale, occ = out[..., :p], out[..., p:p + s], out[..., p + s:]
        bg_pose_raw = None
        if m.has_bg and not m.fix_bg:
            bg_pose_raw = pose[:, :l]
            pose = pose[:, -no * lo:]
            scale = scale[:, -no * lo:]
            occ = occ[:, -no * lo:]

        # ---- object pose ----
        pose = torch.tanh(pose)
        if m.bound_rest:
            min_bound, max_bound = self.min_bound, self.max_bound
            if m.soft_bound_rest:
                rest = ((pose < min_bound) * (pose - min_bound) ** 2
                        + (pose > max_bound) * (pose - max_bound) ** 2)
            else:
                rest = pose ** 2 * ((pose < min_bound) | (pose > max_bound))
        else:
            rest = pose ** 2
        rest = rest.reshape(b * t, -1).mean(-1)
        pose = pose.reshape(b * t, no, lo, 8) * self.mul + self.bias
        delta_pts = pose[..., :2]
        if not m.use_delta:
            delta_pts = delta_pts * 0
        transform = pose[..., 2:].reshape(b * t, no, lo, 3, 2).mean(dim=2)  # (B',No,3,2)
        if m.norm_scale:
            linear = transform[:, :, :2]
            det = (linear[:, :, 0, 0] * linear[:, :, 1, 1]
                   - linear[:, :, 1, 0] * linear[:, :, 0, 1]).abs() + eps
            linear = linear * m.tgt_scale / torch.sqrt(det[..., None, None] + eps)
            transform = torch.cat([linear, transform[:, :, 2:]], dim=2)
        if m.bound_scale:
            sc = (torch.tanh(scale) + 1) / 2
            sc = sc.reshape(b * t, no, lo, 1, 1).mean(dim=2)
            sc = m.min_scale + sc * (m.max_scale - m.min_scale)
            linear = transform[:, :, :2]
            det = (linear[:, :, 0, 0] * linear[:, :, 1, 1]
                   - linear[:, :, 1, 0] * linear[:, :, 0, 1]).abs() + eps
            linear = linear * sc / torch.sqrt(det[..., None, None] + eps)
            transform = torch.cat([linear, transform[:, :, 2:]], dim=2)
        last_obj = None
        if m.use_last_pose_decoder:
            last_obj = torch.cat([
                transform.reshape(b, t, no, 6)[:, m.ctx_len - 1],
                delta_pts.reshape(b, t, no, lo * 2)[:, m.ctx_len - 1],
            ], dim=2)  # (B, No, 6+2Lo)
        pts = self.tgt_pts + delta_pts
        pts = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        obj_pose = torch.matmul(pts, transform).reshape(b, t, no, lo, 2)
        rest = rest.reshape(b, t)

        # ---- occlusion score ----
        occ = occ.reshape(b * t, no, lo).mean(dim=2)
        if m.occ_mode == "normalize":
            mn = occ.amin(dim=1, keepdim=True)
            mx = occ.amax(dim=1, keepdim=True)
            occ_score = (occ - mn) / (mx - mn + eps) * 4 * no
        elif m.occ_mode == "bias":
            occ_score = occ + self.occ_bias[None]
        elif m.occ_mode == "freeze":
            occ_score = torch.ones_like(occ)
        else:
            occ_score = occ
        occ_score = occ_score.reshape(b, t, no)

        # ---- background pose ----
        bg_pose, bg_rest, last_bg = None, None, None
        if m.has_bg:
            if not m.fix_bg:
                bgp = torch.tanh(bg_pose_raw)
                bg_rest = (bgp ** 2).reshape(b * t, -1).mean(-1).reshape(b, t)
                bgp = bgp.reshape(b * t, 1, l, 8) + self.bg_bias
                delta_bg = bgp[..., :2]
                transform_bg = bgp[..., 2:].reshape(b * t, 1, l, 3, 2).mean(dim=2)
                if m.use_last_pose_decoder:
                    last_bg = torch.cat([
                        transform_bg.reshape(b, t, 1, 6)[:, m.ctx_len - 1],
                        delta_bg.reshape(b, t, 1, l * 2)[:, m.ctx_len - 1],
                    ], dim=2)  # (B, 1, 6+2L)
                pts = m.bg_mul * self.tgt_pts_bg + delta_bg
                pts = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
                bg_pose = torch.matmul(pts, transform_bg).reshape(b, t, 1, l, 2)
            else:
                bg_pose = self.tgt_pts_bg[:, None].expand(b, t, 1, l, 2)
            if m.fix_bg1:
                first = self.tgt_pts_bg[:, None].expand(b, 1, 1, l, 2)
                bg_pose = torch.cat([first, bg_pose[:, 1:]], dim=1)

        return obj_pose, bg_pose, occ_score, rest, bg_rest, last_obj, last_bg


class LayerEstimator(_Embeddings):
    """Object queries cross-attending into the context frames' tokens."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        c = m.embed_dim
        no, lo = m.num_obj, m.obj_shape[0] * m.obj_shape[1]
        l = m.latent_shape[0] * m.latent_shape[1]
        if m.decompose_embed_oe:
            self.obj_spatial_embed = nn.Parameter(torch.empty(1, 1, lo, c))
            self.obj_num_embed = nn.Parameter(torch.empty(1, no, 1, c))
            self._embeddings = ("obj_spatial_embed", "obj_num_embed")
        else:
            self.obj_embed = nn.Parameter(torch.empty(1, no, lo, c))
            self._embeddings = ("obj_embed",)
        self.time_embed = nn.Parameter(torch.empty(1, m.oe_num_timesteps, 1, c))
        self.pos_embed = nn.Parameter(torch.empty(1, 1, l, c))
        self._embeddings += ("time_embed", "pos_embed")
        self.norm = CustomNorm(m.norm_layer, c)
        self.blocks = MultiBlocks(m.oe_depth, c, m.num_heads, "obj", m.norm_layer, dtype=dtype)
        self.shard_seq = False  # split the context tokens over the seq ranks
        if m.pred_cls:
            self.cls_norm = CustomNorm(m.norm_layer, c)
            self.cls_head = Dense(c, cfg.data.num_lyt, dtype=dtype)

    def forward(self, x):
        cfg, m = self.cfg, self.cfg.model
        b, t, l, c = x.shape
        no, lo = m.num_obj, m.obj_shape[0] * m.obj_shape[1]
        if m.decompose_embed_oe:
            obj_embed = self.obj_spatial_embed + self.obj_num_embed
        else:
            obj_embed = self.obj_embed
        x = x + self.pos_embed + self.time_embed[:, :t]
        x_obj = obj_embed.expand(b, no, lo, c).reshape(b, no * lo, c)
        if m.has_bg:
            x_bg = self.pos_embed.expand(b, 1, l, c).reshape(b, l, c)
            x_obj = torch.cat([x_bg, x_obj], dim=1)
        x = self.norm(x.reshape(b, t * l, c))
        # the context tokens are sharded, the object queries replicated
        tokens = token_shard(t * l, self.shard_seq)
        x_obj = self.blocks(x_obj, x_ctx=tokens.shard(x), tokens=tokens)
        x_bg = x_obj[:, :l] if m.has_bg else None
        x_obj = x_obj[:, -no * lo:]
        cls = None
        if m.pred_cls:
            x_cls = x_obj.reshape(b, no, lo, c).mean(dim=2)
            cls = self.cls_head(self.cls_norm(x_cls)).softmax(dim=-1)  # (B, No, Nl)
        return x_obj.reshape(b, no, lo, c), x_bg, cls


class LVDNet(nn.Module):
    """The learned LVD submodules, called through their methods."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        self.encoder = ImageEncoder(cfg, input_dtype_string(m), dtype)
        self.layer_estimator = LayerEstimator(cfg, dtype)
        self.pose_estimator = PoseEstimator(cfg, dtype)
        self.decoder = ImageDecoder(cfg, "A", init_mode=m.pe_decoder_init_mode,
                                    use_prior=m.pe_decoder_use_prior, dtype=dtype)
        mask = obj_alpha_border_mask(cfg)
        self.register_buffer("obj_alpha_mask",
                             torch.as_tensor(mask) if mask is not None else None,
                             persistent=False)

    def encode_input(self, vid):
        return self.encoder(vid)

    def estimate_layer(self, x):
        return self.layer_estimator(x)

    def estimate_pose(self, x, x_obj, x_bg):
        return self.pose_estimator(x, x_obj, x_bg)

    def decode_obj_alpha(self, x_obj):
        """x_obj (B,No,Lo,C) -> obj_alpha (B,No,Ho,Wo,1) in [-1,1]."""
        m = self.cfg.model
        alpha = self.decoder(x_obj)
        if m.remove_obj:
            alpha = 0 * alpha - 1
        if m.freeze_obj:
            alpha = 0 * alpha + 1
        if self.obj_alpha_mask is not None:
            mask = self.obj_alpha_mask
            alpha = mask * alpha + (1 - mask) * (-1.0)
        return alpha


# ---- parameterless LVD helpers ----


def obj_alpha_border_mask(cfg):
    """Border zeroing mask for object alpha, (1,1,Ho,Wo,1) numpy or None."""
    m = cfg.model
    if m.pad_obj_alpha <= 0:
        return None
    ho = int(m.obj_shape[0] * m.patch_size * m.scale_factor)
    wo = int(m.obj_shape[1] * m.patch_size * m.scale_factor)
    po = int(m.pad_obj_alpha * m.scale_factor)
    mask = np.ones((ho, wo), np.float32)
    mask[:po] = 0
    mask[:, :po] = 0
    mask[-po:] = 0
    mask[:, -po:] = 0
    return mask.reshape(1, 1, ho, wo, 1)


def bg_alpha_buffer(cfg):
    """Fixed background alpha with border -1, (1,H,W,1) numpy."""
    m = cfg.model
    h, w = cfg.dim, int(cfg.dim * cfg.aspect_ratio)
    bg = np.ones((h, w), np.float32)
    if m.pad_bg_alpha > 0:
        p = int(m.pad_bg_alpha * m.scale_factor)
        bg[:p] = -1
        bg[:, :p] = -1
        bg[-p:] = -1
        bg[:, -p:] = -1
    return bg.reshape(1, h, w, 1)


def compute_occ(occ_score, eps=1e-6):
    """Pairwise occlusion matrix from per-object scores.

    occ_score (B,T,No) -> occ (B,T,No+1,No+1); occ[i,j] = how much layer i
    occludes layer j. The background is occluded by all and occludes none."""
    b, t, no = occ_score.shape
    e = torch.exp(-(occ_score ** 2)) + eps
    occ = e[..., :, None] / (e[..., :, None] + e[..., None, :])
    occ = occ - 0.5 * torch.eye(no, device=occ.device)[None, None]
    occ = torch.cat([torch.ones((b, t, no, 1), dtype=occ.dtype, device=occ.device), occ], dim=3)
    occ = torch.cat([torch.zeros((b, t, 1, no + 1), dtype=occ.dtype, device=occ.device), occ], dim=2)
    return occ


def time_dropout_draws(generator, b, t, no, device=None):
    """reduce_time's time-dropout draws, in the JAX package's order: the
    objects' frame index (B,1,1) and uniforms (B,T,No), then the
    background's (B,1) and (B,T)."""
    kw = dict(generator=generator, device=device)
    return (torch.randint(0, t, (b, 1, 1), **kw), torch.rand((b, t, no), **kw),
            torch.randint(0, t, (b, 1), **kw), torch.rand((b, t), **kw))


def reduce_time(obj, bg, occ_obj_alpha, occ_bg_alpha, eps=1e-6, generator=None, draws=None):
    """Occlusion-weighted mean over time of the layers' textures, each with
    its alpha appended: obj (B,T,No,Ho,Wo,C), occ_obj_alpha (B,T,No,Ho,Wo,1)
    -> (B,No,Ho,Wo,C+1); bg (B,T,H,W,C), occ_bg_alpha (B,T,H,W,1) ->
    (B,H,W,C+1). Time dropout (``draws`` as ``time_dropout_draws`` makes
    them, or drawn from ``generator``) keeps, per clip and layer, the frames
    whose uniform is at least that of one frame drawn at random."""
    b, t, no = occ_obj_alpha.shape[:3]
    if draws is None and generator is not None:
        draws = time_dropout_draws(generator, b, t, no, obj.device)
    score_o = (occ_obj_alpha + 1) / 2 + eps  # B T No Ho Wo 1
    score_b = (occ_bg_alpha + 1) / 2 + eps  # B T H W 1
    if draws is not None:
        ti_o, rd_o, ti_b, rd_b = draws
        keep_o = rd_o >= rd_o.gather(1, ti_o.expand(b, 1, no))
        score_o = score_o * keep_o.to(score_o.dtype)[..., None, None, None]
        keep_b = rd_b >= rd_b.gather(1, ti_b)
        score_b = score_b * keep_b.to(score_b.dtype)[..., None, None, None]
    score_o = score_o / score_o.sum(dim=1, keepdim=True)
    obj = (torch.cat([obj, occ_obj_alpha], dim=-1) * score_o).sum(dim=1)
    score_b = score_b / score_b.sum(dim=1, keepdim=True)
    bg = (torch.cat([bg, occ_bg_alpha], dim=-1) * score_b).sum(dim=1)
    return obj, bg


def reduce_comp(vid, occ, flow):
    """Alpha-composite per-layer videos: vid (B,T,No+1,H,W,C+1) in [-1, 1]
    (the last channel the alpha; the background's is taken as 1), occ
    (B,T,No+1,No+1), flow (B,T-1,No+1,H,W,2) -> the video (B,T,H,W,C) in
    [-1, 1], the occluded alphas (B,T,No+1,H,W) in [-1, 1] and the
    composited flow (B,T-1,H,W,2)."""
    vid = (vid + 1) / 2
    alpha = torch.cat([torch.ones_like(vid[:, :, :1, ..., -1:]), vid[:, :, 1:, ..., -1:]], dim=2)
    occp = torch.prod(1 - alpha[:, :, :, None] * occ[:, :, :, :, None, None, None], dim=2)
    alpha = occp * alpha
    out = (alpha * vid[..., :-1]).sum(dim=2)
    flow = (alpha[:, :-1] * flow).sum(dim=2)
    return 2 * out - 1, 2 * alpha[..., 0] - 1, flow
