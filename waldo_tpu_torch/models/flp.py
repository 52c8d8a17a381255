"""FLP, the future layer prediction transformer (counterpart of
waldo_tpu/models/flp.py).

Every tensor keeps its static (B, T[+1], No+1) shape; context selection is
done with attention key masks and where-selects, as in the JAX package.

Shapes: obj_pose (B,T,No,Lo,2), bg_pose (B,T,1,L,2), occ_score (B,T,No),
x_obj (B,No,Lo,C), x_bg (B,L,C), ctx_mask (B,T) bool (True = context).

Training adds the JAX package's noise where the config asks for it
(``pg_embed_noise``: one N(0, 1) draw per clip on the prediction slots'
initial tokens; ``pg_inject_noise``: token noise in the decoder's self
attention), drawn from the ``noise`` stream the caller hands the forward (a
``parallel.RowStream``, which draws at the global batch's shape and keeps
the rank's rows); inference (no stream) is deterministic.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import Block, CustomNorm, Dense, MultiBlocks
from ..nn.init import trunc_normal_
from ..ops import get_grid


class LatentCompressor(nn.Module):
    """CLS-token attention pooling per layer: (..., L, C) -> (..., C)."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.embed_dim = m.embed_dim
        self.norm = CustomNorm(m.norm_layer, m.embed_dim)
        self.cls_embed = nn.Parameter(torch.empty(1, 1, m.embed_dim))
        self.blocks = MultiBlocks(m.pg_com_depth, m.embed_dim, m.num_heads, "cls",
                                  m.norm_layer, dtype=dtype)

    def init_parameters(self, generator):
        trunc_normal_(self.cls_embed, generator)

    def forward(self, x):
        lead = tuple(x.shape[:-2])
        x = self.norm(x.reshape((-1,) + tuple(x.shape[-2:])))
        z = self.cls_embed.expand(x.shape[0], 1, self.embed_dim)
        z = self.blocks(z, x_ctx=x)
        return z.reshape(lead + (self.embed_dim,))


class PoseEncoder(nn.Module):
    """Pose-token embedding and masked full attention over the context slots."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        c = m.embed_dim
        lo = m.obj_shape[0] * m.obj_shape[1]
        l = m.latent_shape[0] * m.latent_shape[1]
        self.lay_embed = nn.Parameter(torch.empty(1, 1, m.num_obj + 1, c))
        self.time_embed = nn.Parameter(torch.empty(1, m.pg_num_timesteps + 1, 1, c))
        self.to_obj_emb = Dense(lo * 2 + 1, c, dtype=dtype)
        self.to_bg_emb = Dense(l * 2, c, dtype=dtype)
        self.blocks = MultiBlocks(m.pg_enc_depth, c, m.num_heads, "full", m.norm_layer,
                                  dtype=dtype)
        self.norm = CustomNorm(m.norm_layer, c)

    def init_parameters(self, generator):
        trunc_normal_(self.lay_embed, generator)
        trunc_normal_(self.time_embed, generator)

    def forward(self, obj_pose, bg_pose, occ_score, z, ctx_mask, noise=None):
        m = self.cfg.model
        b, t, no, lo, _ = obj_pose.shape
        l = m.latent_shape[0] * m.latent_shape[1]
        c = m.embed_dim
        xo = self.to_obj_emb(torch.cat([obj_pose.reshape(b, t, no, lo * 2),
                                        occ_score[..., None]], dim=-1))  # B T No C
        xb = self.to_bg_emb(bg_pose.reshape(b, t, 1, l * 2))  # B T 1 C
        x = torch.cat([xb, xo], dim=2)  # B T No+1 C

        z = z.reshape(b, 1, no + 1, c)
        if m.cat_z:
            x = torch.cat([z, x], dim=1)  # B T+1 No+1 C
            ctx_mask = torch.cat([torch.ones_like(ctx_mask[:, :1]), ctx_mask], dim=1)
            tt = t + 1
        else:
            tt = t
        x = x + self.time_embed[:, :tt] + self.lay_embed

        key_mask = ctx_mask.repeat_interleave(no + 1, dim=1)  # B tt*(No+1)
        x = self.blocks(x.reshape(b, tt * (no + 1), c), key_mask=key_mask)
        x = self.norm(x).reshape(b, tt, no + 1, c)
        x_init = (self.time_embed[:, :tt] + self.lay_embed).expand(b, tt, no + 1, c)
        if m.pg_embed_noise and noise is not None:
            x_init = x_init + noise.randn((b, 1, 1, c), x.device)
        x = torch.where(ctx_mask[:, :, None, None], x, x_init)
        return x, ctx_mask  # ctx_mask now includes the z slot when cat_z


class PoseDecoder(nn.Module):
    """Interleaved self (pred) / cross (ctx) attention and the pose heads."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        if m.pg_modulate_noise:
            raise NotImplementedError(
                "pg_modulate_noise is refused as in the JAX package, which cannot build such "
                "an FLP: Synthesizer.init_params raises IndexError there (its init runs FLP "
                "deterministically, so z_cond is None and the full_with_cond_norm Block feeds "
                "None to its Mlp; waldo_tpu/models/flp.py:116-128, "
                "waldo_tpu/nn/transform.py:384-388)")
        self.cfg = cfg
        c = m.embed_dim
        lo = m.obj_shape[0] * m.obj_shape[1]
        l = m.latent_shape[0] * m.latent_shape[1]
        self.self_blocks = nn.ModuleList(
            Block(c, m.num_heads, "full", m.norm_layer, noise=m.pg_inject_noise, dtype=dtype)
            for _ in range(m.pg_dec_depth))
        self.cross_blocks = nn.ModuleList(
            Block(c, m.num_heads, "cross", m.norm_layer, dtype=dtype)
            for _ in range(m.pg_dec_depth))
        self.norm = CustomNorm(m.norm_layer, c)
        self.obj_head = Dense(c, 6 + 2 * lo + 1, dtype=dtype, zero_init=m.zero_init_dec)
        self.bg_head = Dense(c, 6 + 2 * l, dtype=dtype, zero_init=m.zero_init_dec)
        self.register_buffer("tgt_pts_obj", torch.as_tensor(get_grid(*m.obj_shape))
                             .reshape(1, 1, 1, lo, 2), persistent=False)
        self.register_buffer("tgt_pts_bg", torch.as_tensor(get_grid(*m.latent_shape))
                             .reshape(1, 1, 1, l, 2), persistent=False)
        # the pose heads' constant rows, built once here: a tensor made from a
        # list inside forward is a host-to-device copy that waits for the
        # queued work
        if m.unconstrained_pose_decoder:
            init_scale, mul_scale = 1.0, 1.0
        else:
            init_scale, mul_scale = m.init_scale_obj, m.mul_scale_obj
        ar = cfg.aspect_ratio
        self.register_buffer("bias_obj", torch.tensor([init_scale, 0, 0, ar * init_scale, 0, 0]),
                             persistent=False)
        self.register_buffer("bias_bg", torch.tensor([1.0, 0, 0, 1, 0, 0]), persistent=False)
        self.register_buffer("mul_obj", torch.tensor([mul_scale] * 4 + [1.0, 1.0]),
                             persistent=False)

    def forward(self, obj_pose, bg_pose, occ_score, x, ctx_mask_ext, last_obj=None,
                last_bg=None, noise=None):
        m = self.cfg.model
        b, tt, nlay, c = x.shape
        no = nlay - 1
        lo = m.obj_shape[0] * m.obj_shape[1]
        l = m.latent_shape[0] * m.latent_shape[1]

        pred_mask_ext = ~ctx_mask_ext  # (B, tt)
        key_ctx = ctx_mask_ext.repeat_interleave(nlay, dim=1)
        key_pred = pred_mask_ext.repeat_interleave(nlay, dim=1)

        tokens = x.reshape(b, tt * nlay, c)
        x_pred = tokens
        for self_blk, cross_blk in zip(self.self_blocks, self.cross_blocks):
            x_pred = self_blk(x_pred, key_mask=key_pred, noise=noise)
            x_pred = cross_blk(x_pred, x_ctx=tokens, key_mask=key_ctx)

        x_pred = self.norm(x_pred).reshape(b, tt, nlay, c)
        out_obj = self.obj_head(x_pred[:, :, 1:])  # B tt No 6+2Lo+1
        out_bg = self.bg_head(x_pred[:, :, :1])  # B tt 1 6+2L
        pred_obj = torch.tanh(out_obj[..., :-1])
        pred_occ = out_obj[..., -1]
        pred_bg = torch.tanh(out_bg)

        if m.use_last_pose_decoder:
            pred_obj = pred_obj + last_obj[:, None]
            pred_bg = pred_bg + last_bg[:, None]

        mul_delta = 1.0 if m.unconstrained_pose_decoder else m.mul_delta_obj
        if m.use_last_pose_decoder:
            bias_obj, bias_bg = 0.0, 0.0
        else:
            bias_obj, bias_bg = self.bias_obj, self.bias_bg

        transform = (self.mul_obj * pred_obj[..., :6] + bias_obj).reshape(b, tt, no, 3, 2)
        delta_pts = (mul_delta * pred_obj[..., 6:]).reshape(b, tt, no, lo, 2)
        pts = self.tgt_pts_obj + delta_pts
        pts = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        pred_obj_pose = torch.matmul(pts, transform)

        transform_bg = (pred_bg[..., :6] + bias_bg).reshape(b, tt, 1, 3, 2)
        delta_bg = pred_bg[..., 6:].reshape(b, tt, 1, l, 2)
        pts = m.bg_mul_pose_decoder * self.tgt_pts_bg + delta_bg
        pts = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        pred_bg_pose = torch.matmul(pts, transform_bg)

        # drop the z slot, put the predictions at the pred positions
        if m.cat_z:
            pred_obj_pose = pred_obj_pose[:, 1:]
            pred_bg_pose = pred_bg_pose[:, 1:]
            pred_occ = pred_occ[:, 1:]
            pred_mask = pred_mask_ext[:, 1:]
        else:
            pred_mask = pred_mask_ext
        obj_out = torch.where(pred_mask[:, :, None, None, None], pred_obj_pose, obj_pose)
        bg_out = torch.where(pred_mask[:, :, None, None, None], pred_bg_pose, bg_pose)
        occ_out = torch.where(pred_mask[:, :, None], pred_occ, occ_score)
        return obj_out, bg_out, occ_out


class FLPNet(nn.Module):
    """compress -> encode -> decode."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.compress = LatentCompressor(cfg, dtype)
        self.encode = PoseEncoder(cfg, dtype)
        self.decode = PoseDecoder(cfg, dtype)

    def forward(self, obj_pose, bg_pose, occ_score, x_obj, x_bg, last_obj, last_bg, ctx_mask,
                noise=None):
        """``noise``: the training noise's stream (a RowStream on the
        inputs' device); None runs deterministic inference."""
        z_obj = self.compress(x_obj)  # (B, No, C)
        z_bg = self.compress(x_bg[:, None])  # (B, 1, C)
        z = torch.cat([z_bg, z_obj], dim=1)  # (B, No+1, C)
        x, ctx_mask_ext = self.encode(obj_pose, bg_pose, occ_score, z, ctx_mask, noise=noise)
        return self.decode(obj_pose, bg_pose, occ_score, x, ctx_mask_ext,
                           last_obj=last_obj, last_bg=last_bg, noise=noise)
