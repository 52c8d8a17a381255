"""Warper, the geometry engine of LVD (counterpart of
waldo_tpu/models/warper.py): no learned parameters.

Alphas live in [-1, 1] and are used as (a+1)/2; the per-layer occlusion of
occludee j is prod_i (1 - alpha_i * occ[i, j]) over occluders i; unresolved
inverse-warp pixels sit far out of bounds so a zero-padded sample reads 0.

Per-layer maps keep the layer axis right after time ((B,T,No+1,H,W,C));
"squeezed" per-layer alphas put the layers in the channel axis
((B,T,H,W,No+1)).

Ported: grid construction (the scatter inversion of the training configs
and the iterative one of the flagship predict), the layer <-> output
samples, the texture gathers into the layers' frames (``decode_layer``'s
``layer_from_input`` and the occlusion-aware ``alpha_to_alpha``), the flow
synthesis and context fusion in both forms (the predict
path's ``ctx_uniform=True``, one fused alpha_ctx warp; the training path's
unfused per-layer sample, occlusion product and gathered context fusion,
which are differentiable), and the per-layer flows the MAT post-processing
propagates along.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import InverseWarp, TPSWarp, get_grid, grid_sample, resize
from ..ops.grid_sample import grid_sample_ctx, grid_sample_multigrid, warp_alpha_ctx
from ..utils import gather_time
from ..utils.profiling import annotate


class WarpGrids(NamedTuple):
    tgt_obj: Optional[torch.Tensor]  # (B,T,No,Ho,Wo,2) object-layer sampling grid
    src_obj: Optional[torch.Tensor]  # (B,T,No,H,W,2) inverse grid
    tgt_bg: Optional[torch.Tensor]   # (B,T,H,W,2)
    src_bg: Optional[torch.Tensor]   # (B,T,H,W,2)


def _bsample(img, grid):
    """grid_sample with arbitrary leading axes folded into the batch."""
    lead = tuple(img.shape[:-3])
    out = grid_sample(img.reshape((-1,) + tuple(img.shape[-3:])),
                      grid.reshape((-1,) + tuple(grid.shape[-3:])))
    return out.reshape(lead + tuple(out.shape[1:]))


class Warper:
    def __init__(self, cfg, device="cuda"):
        m = cfg.model
        self.num_obj = m.num_obj
        self.tgt_shape = (
            int(m.obj_shape[0] * m.patch_size * m.scale_factor),
            int(m.obj_shape[1] * m.patch_size * m.scale_factor),
        )
        self.src_shape = (cfg.dim, int(cfg.dim * cfg.aspect_ratio))
        self.src_shape_hd = (
            (cfg.load_dim, int(cfg.load_dim * cfg.aspect_ratio))
            if cfg.load_dim > 0 else self.src_shape
        )
        self.scale_hd = cfg.load_dim / cfg.dim if cfg.load_dim > 0 else 1.0
        src_pts = get_grid(*m.latent_shape).reshape(-1, 2)
        tgt_pts = get_grid(*m.obj_shape).reshape(-1, 2)
        self.src_grid = torch.as_tensor(get_grid(*self.src_shape), device=device)
        self.src_grid_hd = torch.as_tensor(get_grid(*self.src_shape_hd), device=device)
        self.tps_obj = TPSWarp(*self.tgt_shape, tgt_pts, device=device)
        self.tps_bg = TPSWarp(*self.src_shape, src_pts, device=device)
        self.invert_obj = InverseWarp(*self.tgt_shape, *self.src_shape, device=device)
        self.invert_bg = InverseWarp(*self.src_shape, *self.src_shape, device=device)
        self.weight_cls = m.weight_cls
        self.min_cls = m.min_cls
        self.include_self = m.include_self
        self.no_filter = m.no_filter
        self.allow_ghost = m.allow_ghost
        self.fast_inverse_warp = m.fast_inverse_warp
        self.sample_precision = m.sample_precision

    # ---- grid construction ----

    def __call__(self, obj_pose, bg_pose) -> WarpGrids:
        if self.fast_inverse_warp:
            inv_o, inv_b = self.invert_obj.iterative, self.invert_bg.iterative
        else:
            inv_o, inv_b = self.invert_obj, lambda g: self.invert_bg(g, erode=False)
        b, t, no, lo, _ = obj_pose.shape
        with annotate("warper/tps_obj"):
            tgt_obj = self.tps_obj(obj_pose.reshape(b * t * no, lo, 2))
        with annotate("warper/invert_obj"):
            src_obj = inv_o(tgt_obj)
        tgt_obj = tgt_obj.reshape((b, t, no) + tuple(tgt_obj.shape[1:]))
        src_obj = src_obj.reshape((b, t, no) + tuple(src_obj.shape[1:]))

        l = bg_pose.shape[2]
        with annotate("warper/tps_bg"):
            tgt_bg = self.tps_bg(bg_pose.reshape(b * t, l, 2))
        with annotate("warper/invert_bg"):
            src_bg = inv_b(tgt_bg)
        tgt_bg = tgt_bg.reshape((b, t) + tuple(tgt_bg.shape[1:]))
        src_bg = src_bg.reshape((b, t) + tuple(src_bg.shape[1:]))
        return WarpGrids(tgt_obj, src_obj, tgt_bg, src_bg)

    # ---- texture gathers into the layers' frames ----

    def obj_from_input(self, x, grids: WarpGrids):
        """x (B,T,H,W,C) or per-layer (B,T,No+1,H,W,C) -> obj (B,T,No,Ho,Wo,C)."""
        b, t = x.shape[:2]
        if x.dim() == 5:
            x = x[:, :, None].expand((b, t, self.num_obj) + tuple(x.shape[2:]))
        else:
            x = x[:, :, 1:]
        return _bsample(x, grids.tgt_obj)

    def bg_from_input(self, x, grids: WarpGrids):
        """x (B,T,H,W,C) or per-layer (B,T,No+1,H,W,C) -> bg (B,T,H,W,C)."""
        if x.dim() == 6:
            x = x[:, :, 0]
        return _bsample(x, grids.tgt_bg)

    def layer_from_input(self, x, grids):
        return self.obj_from_input(x, grids), self.bg_from_input(x, grids)

    # ---- layer -> output samples ----

    def obj_to_output(self, obj, grids: WarpGrids, delta=1.0):
        """obj (B,[T,]No,Ho,Wo,C) -> (B,T,No,H,W,C) via src_obj grids; delta
        shifts values so zero padding reads as -delta."""
        b, t = grids.src_obj.shape[:2]
        if obj.dim() == 5:
            obj = obj[:, None].expand((b, t) + tuple(obj.shape[1:]))
        return _bsample(obj + delta, grids.src_obj) - delta

    def bg_to_output(self, bg, grids: WarpGrids, delta=1.0):
        """bg (B,[T,]H,W,C) -> (B,T,1,H,W,C) via src_bg grids."""
        b, t = grids.src_bg.shape[:2]
        if bg.dim() == 4:
            bg = bg[:, None].expand((b, t) + tuple(bg.shape[1:]))
        return (_bsample(bg + delta, grids.src_bg) - delta)[:, :, None]

    def layer_to_output(self, obj, bg, grids, delta_bg=1.0, delta_obj=1.0):
        out_obj = self.obj_to_output(obj, grids, delta_obj)
        out_bg = self.bg_to_output(bg, grids, delta_bg)
        return torch.cat([out_bg, out_obj], dim=2)  # (B,T,No+1,H,W,C)

    @staticmethod
    def occlusion_product(alpha, occ, dtype=None):
        """alpha (B,T,I,H,W,1) in [0,1], occ (B,T,I,J) ->
        (B,T,J,H,W,1): prod_i (1 - alpha_i * occ[i, j]), as a loop over the
        occluders i so memory stays at (B,T,J,H,W,1). With
        ``dtype=bfloat16`` ("fast") the factors and the pairwise products
        are rounded to bf16 and the running product to bf16 once at the end,
        the rounding the JAX package's compiled product shows."""
        a, o = alpha, occ
        if dtype is not None:
            a, o = a.to(dtype), o.to(dtype)
        out = None
        for i in range(a.shape[2]):
            term = 1.0 - (a[:, :, i:i + 1] * o[:, :, i, :, None, None, None]).float()
            out = term if out is None else out * term
        if dtype is not None:
            out = out.to(dtype)
        return out.to(alpha.dtype)

    def alpha_to_alpha(self, obj_alpha, bg_alpha, grids, occ):
        """The layers' alphas (obj (B,No,Ho,Wo,1), bg (B,H,W,1)) in each
        frame: the output alphas (B,T,No+1,H,W,1) in [0, 1] after the
        occlusion product, and that product gathered back into the layers'
        frames times their alphas, in [-1, 1]."""
        b, t = grids.src_obj.shape[:2]
        obj_alpha = obj_alpha[:, None].expand((b, t) + tuple(obj_alpha.shape[1:]))
        bg_alpha = bg_alpha[:, None].expand((b, t) + tuple(bg_alpha.shape[1:]))
        out = (self.layer_to_output(obj_alpha, bg_alpha, grids) + 1.0) / 2.0
        occp = self.occlusion_product(out, occ)
        out = occp * out
        obj_occ, bg_occ = self.layer_from_input(occp, grids)
        return obj_occ * (obj_alpha + 1.0) - 1.0, bg_occ * (bg_alpha + 1.0) - 1.0, out

    # ---- dense flow synthesis ----

    def grid_to_flow(self, x, grids: WarpGrids, occ, obj_alpha, bg_alpha, cls, ctx_ts,
                     pred_ts, restrict_to_ctx=False, hd_window=None, ctx_uniform=False):
        """Dense ctx->pred flow per layer, occlusion-merged.

        x: (B,T,Hd,Wd,3+Nl) rgb+layout at load resolution
        occ: (B,T,No+1,No+1); obj_alpha (B,No,Ho,Wo,1); bg_alpha (B,H,W,1)
        cls: (B,No,Nl) or None; ctx_ts (B,Tc,Tp) int; pred_ts (Tp,) int
        returns flow (B,Tc,Tp,Hd,Wd,2), alpha_unflt/alpha (B,T*,Hd,Wd,No+1),
        alpha_ctx (B,Tc,Tp,Hd,Wd,No+1), disocc (B,Tc,Tp,Hd,Wd,1)

        ctx_uniform: the caller's promise that ctx_ts is constant along the
        pred axis, which lets the fused alpha_ctx warp (one kernel on a CUDA
        device, no backward) read each unique context frame once. Otherwise
        (the training path) each (ctx, pred) pair's alphas are gathered and
        sampled per layer (one per-channel-grid kernel on a CUDA device),
        then masked, maxed, occluded and reduced in differentiable PyTorch.
        hd_window: only frames [0, hd_window) get the per-frame HD work (the
        frames gathered downstream)."""
        b, t = x.shape[:2]
        tc, tp = ctx_ts.shape[1], pred_ts.shape[0]
        no = self.num_obj
        h, w = self.src_shape
        hd, wd = self.src_shape_hd
        ho, wo = self.tgt_shape
        ident = lambda tensor: tensor

        hd_x = x
        x = resize(hd_x, 1.0 / self.scale_hd) if self.scale_hd != 1 else hd_x
        to_window = (lambda tensor: tensor[:, :tc]) if restrict_to_ctx else ident
        to_pred = lambda tensor: tensor[:, pred_ts]

        # rough alpha projected into every frame
        obj_a = ((obj_alpha + 1) / 2)[:, None].expand(b, t, no, ho, wo, 1)
        bg_a = ((bg_alpha + 1) / 2)[:, None].expand(b, t, h, w, 1)
        alpha = self.layer_to_output(obj_a, bg_a, grids, delta_bg=0.0, delta_obj=0.0)
        alpha = to_window(alpha)  # (B,Tw,No+1,H,W,1)
        tw = alpha.shape[1]
        to_hd = ((lambda tensor: tensor[:, :hd_window])
                 if (hd_window is not None and hd_window < tw) else ident)

        # layout-agreement alpha refinement
        if not self.no_filter:
            with annotate("warper/lyt_refine"):
                lyt = to_window(x)[..., 3:]  # (B,Tw,H,W,Nl)
                hd_lyt = to_hd(to_window(hd_x))[..., 3:]  # (B,Tw',Hd,Wd,Nl)
                if cls is None or self.weight_cls:
                    alpha_win = alpha[:, :, 1:, ..., 0] + 1e-6  # B Tw No H W
                    if self.weight_cls:
                        sm = lyt.softmax(dim=-1)
                        cl = cls.float() + self.min_cls  # B No Nl
                        alpha_win = alpha_win * torch.einsum("bthwl,bnl->btnhw", sm, cl)
                    sum_alpha_win = alpha_win.sum(dim=(1, 3, 4))  # B No
                    mean_lyt_win = (torch.einsum("bthwl,btnhw->bnl", lyt, alpha_win)
                                    / sum_alpha_win[..., None])  # B No Nl
                    lyt_alpha = (mean_lyt_win.softmax(dim=-1)[:, None, :, None, None, :]
                                 - hd_lyt.softmax(dim=-1)[:, :, None]).abs()
                else:
                    cl = cls[:, None, :, None, None, :]
                    lyt_alpha = (cl - hd_lyt.softmax(dim=-1)[:, :, None]).abs()
                lyt_alpha = 1.0 - lyt_alpha.sum(dim=-1, keepdim=True) / 2.0  # B Tw' No Hd Wd 1

        alpha = to_hd(alpha)
        if self.scale_hd != 1:
            with annotate("warper/alpha_upsample"):
                alpha = resize(alpha, self.scale_hd)
        if not self.no_filter:
            alpha = torch.cat([alpha[:, :, :1], alpha[:, :, 1:] * lyt_alpha], dim=2)

        # occlusion among the layers of each frame
        occ_dtype = torch.bfloat16 if self.sample_precision == "fast" else None
        with annotate("warper/occ_product_frame"):
            occ_w = to_hd(to_window(occ))
            occp = self.occlusion_product(alpha, occ_w, dtype=occ_dtype)
            alpha = occp * alpha  # B Tw' No+1 Hd Wd 1
        alpha_unflt = alpha

        pair_grids = WarpGrids(None, to_pred(grids.src_obj), None, to_pred(grids.src_bg))

        # flow fields in layer referentials, ctx in channels
        obj_flow = gather_time(grids.tgt_obj, ctx_ts) - to_pred(grids.tgt_obj)[:, None]
        obj_flow = obj_flow.movedim(1, -2).reshape(b, tp, no, ho, wo, tc * 2)
        bg_flow = gather_time(grids.tgt_bg, ctx_ts) - to_pred(grids.tgt_bg)[:, None]
        bg_flow = bg_flow.movedim(1, -2).reshape(b, tp, h, w, tc * 2)

        # ghost-object suppression, broadcast over the ctx axis
        io = None
        if restrict_to_ctx and not self.allow_ghost:
            ones = torch.ones_like(obj_flow[..., :1])
            is_obj = self.obj_to_output(ones, pair_grids, delta=0.0)  # B Tp No H W 1
            if self.scale_hd != 1:
                is_obj = resize(is_obj, self.scale_hd)
            is_obj = (is_obj > 0.9).to(x.dtype).reshape(b, tp, no, hd, wd)
            io = torch.cat([torch.ones_like(is_obj[:, :, :1]), is_obj], dim=2)  # B Tp No+1 Hd Wd

        # warp the layer flows to the output frame; ctx channels back to an axis
        with annotate("warper/flow_warp"):
            flow = self.layer_to_output(obj_flow, bg_flow, pair_grids, delta_bg=0.0, delta_obj=0.0)
        flow = flow.reshape(b, tp, no + 1, h, w, tc, 2).movedim(-2, 1)  # B Tc Tp No+1 H W 2
        if self.scale_hd != 1:
            with annotate("warper/flow_upsample"):
                flow = resize(flow, self.scale_hd)
        sample_grid = self.src_grid_hd + flow.reshape(-1, no + 1, hd, wd, 2)
        to_chan_last = lambda a: a[..., 0].movedim(2, -1) * 2.0 - 1.0

        if not ctx_uniform:
            alpha_ctx, disocc, flow = self._alpha_ctx_unfused(
                alpha, sample_grid, flow, occ, io, ctx_ts, to_pred, occ_dtype)
            return (flow, to_chan_last(alpha_unflt), to_chan_last(alpha),
                    alpha_ctx * 2.0 - 1.0, disocc)

        # fused path: gather only the unique ctx frames and run sample + ghost
        # mask + disocc + occlusion product + flow reduction as one op
        with annotate("warper/alpha_ctx_fused"):
            bi = torch.arange(b, device=alpha.device)[:, None]
            alpha_u = alpha[bi, ctx_ts[:, :, 0].to(alpha.device)]  # B Tc No+1 Hd Wd 1
            tex = alpha_u[..., 0].movedim(2, -1).reshape(b * tc, hd, wd, no + 1)
            occ_n = to_pred(occ)[:, None].expand(b, tc, tp, no + 1, no + 1)
            alpha_occ, disocc, flow = warp_alpha_ctx(
                tex, sample_grid, occ_n.reshape(b * tc * tp, no + 1, no + 1),
                None if io is None else io.reshape(b * tp, no + 1, hd, wd),
                tp_sz=tp, tcp=tc * tp)
        alpha_ctx = alpha_occ.reshape(b, tc, tp, hd, wd, no + 1)
        if occ_dtype is not None:
            alpha_ctx = alpha_ctx.to(occ_dtype)
        disocc = disocc.reshape(b, tc, tp, hd, wd, 1)
        flow = flow.reshape(b, tc, tp, hd, wd, 2)
        return (flow, to_chan_last(alpha_unflt), to_chan_last(alpha),
                alpha_ctx * 2.0 - 1.0, disocc)

    def _alpha_ctx_unfused(self, alpha, sample_grid, flow, occ, io, ctx_ts, to_pred,
                           occ_dtype):
        """The training path's alpha_ctx warp: every (ctx, pred) pair's
        alphas sampled per layer along its grids, the ghost mask, the
        disocclusion max, the occlusion at prediction time and the
        alpha-weighted flow reduction. alpha (B,Tw,No+1,Hd,Wd,1) in [0,1],
        sample_grid (B*Tc*Tp,No+1,Hd,Wd,2), flow (B,Tc,Tp,No+1,Hd,Wd,2).
        Returns alpha_ctx (B,Tc,Tp,Hd,Wd,No+1) in [0,1], stored in bf16 with
        "fast" sampling, disocc (B,Tc,Tp,Hd,Wd,1) and the flow
        (B,Tc,Tp,Hd,Wd,2) in float32."""
        b, tc, tp, n1, hd, wd = flow.shape[:6]
        alpha_ctx = gather_time(alpha[..., 0], ctx_ts)  # B Tc Tp No+1 Hd Wd
        with annotate("warper/alpha_ctx_sample"):
            alpha_ctx = grid_sample_multigrid(
                alpha_ctx.reshape(-1, n1, hd, wd).movedim(1, -1), sample_grid)
        alpha_ctx = alpha_ctx.movedim(-1, 1).reshape(b, tc, tp, n1, hd, wd)
        if occ_dtype is not None:
            # "fast" stores the (B,Tc,Tp,No+1,Hd,Wd) alpha maps in bf16
            alpha_ctx = alpha_ctx.to(occ_dtype)
        if io is not None:
            alpha_ctx = alpha_ctx * io[:, None].to(alpha_ctx.dtype)
        disocc = alpha_ctx.amax(dim=3)[..., None]  # B Tc Tp Hd Wd 1

        # occlusion at prediction time: a loop over the occluders
        with annotate("warper/occ_product_pred"):
            occ_p = to_pred(occ)[:, None].expand(b, tc, tp, n1, n1).reshape(b, tc * tp, n1, n1)
            a6 = alpha_ctx.reshape(b, tc * tp, n1, hd, wd, 1)
            occp = self.occlusion_product(a6, occ_p, dtype=occ_dtype)
            alpha_ctx = (occp * a6).reshape(b, tc, tp, n1, hd, wd)

        # alpha-weighted flow reduction, accumulated in float32
        with annotate("warper/flow_reduce"):
            flow = (alpha_ctx.float()[..., None] * flow).sum(dim=3)  # B Tc Tp Hd Wd 2
        return alpha_ctx.movedim(3, -1), disocc, flow

    # ---- warp the context frames and fuse ----

    def input_to_output(self, x, alpha, flow, ctx_ts, eps=1e-6, ctx_uniform=False):
        """x (B,T,Hd,Wd,C); alpha (B,Tc,Tp,Hd,Wd,No+1) in [-1,1];
        flow (B,Tc,Tp,Hd,Wd,2); returns (output (B,Tp,Hd,Wd,C+1),
        raw (B,Tc',Tp,Hd,Wd,C+No+1))."""
        b, tc, tp = flow.shape[:3]
        hd, wd = self.src_shape_hd
        c = x.shape[-1]
        grid = self.src_grid_hd + flow.reshape(-1, hd, wd, 2)
        if ctx_uniform:
            # gather the unique ctx frames; the sampler's tp_sz row mapping
            # fans each out to its tp grids without materializing the copies
            bi = torch.arange(b, device=x.device)[:, None]
            ctx_u = x[bi, ctx_ts[:, :, 0].to(x.device)]  # B Tc Hd Wd C
            with annotate("warper/context_fusion_sample"):
                out = grid_sample_ctx(ctx_u.reshape(-1, hd, wd, c), grid, tp_sz=tp)
        else:
            # training path: every (ctx, pred) pair's frame, gathered; the
            # generic sampler takes the kernel's batch mode at these sizes
            ctx = gather_time(x, ctx_ts)  # B Tc Tp Hd Wd C
            with annotate("warper/context_fusion_sample"):
                out = grid_sample(ctx.reshape(-1, hd, wd, c), grid)
        out = out.reshape(b, tc, tp, hd, wd, c)
        if self.sample_precision == "fast":
            # bf16 storage of the warped-context stack; the fused output
            # accumulates in float32 below
            out = out.to(torch.bfloat16)
            alpha = alpha.to(torch.bfloat16)

        with annotate("warper/fuse_score"):
            score = ((alpha + 1) / 2).sum(dim=-1, keepdim=True)  # B Tc Tp Hd Wd 1
            if self.include_self and tp == x.shape[1]:
                score = torch.cat([score, torch.ones_like(score[:, :1])], dim=1)
                alpha = torch.cat([alpha, torch.ones_like(alpha[:, :1])], dim=1)
                out = torch.cat([out, x[:, None].to(out.dtype)], dim=1)
            raw_output = torch.cat([out, alpha], dim=-1)  # B Tc' Tp Hd Wd C+No+1
            output = torch.cat([out, (score * 2 - 1).to(out.dtype)], dim=-1)
            score = (score + eps) / (score + eps).sum(dim=1, keepdim=True)
            output = (output.float() * score.float()).sum(dim=1)  # B Tp Hd Wd C+1
        return output, raw_output

    # ---- per-layer flows for the MAT propagation ----

    def grid_to_bg_flow_from_ref_to_pred(self, grids: WarpGrids, ctx_len, ref):
        """Background flow from frame ``ref`` to every predicted frame,
        (B, Tp, Hd, Wd, 2)."""
        bg_flow = grids.tgt_bg[:, ref][:, None] - grids.tgt_bg[:, ctx_len:]  # B Tp H W 2
        g = WarpGrids(None, None, None, grids.src_bg[:, ctx_len:])
        out = self.bg_to_output(bg_flow, g, delta=0.0)[:, :, 0]
        if self.scale_hd != 1:
            out = resize(out, self.scale_hd)
        return out

    def grid_to_obj_flow_from_ref_to_pred(self, grids: WarpGrids, ctx_len, ref, obj_id):
        """Flow of object ``obj_id`` from frame ``ref`` to every predicted
        frame, (B, Tp, Hd, Wd, 2)."""
        of = grids.tgt_obj[:, ref, obj_id][:, None] - grids.tgt_obj[:, ctx_len:, obj_id]
        g = WarpGrids(None, grids.src_obj[:, ctx_len:, obj_id][:, :, None], None, None)
        out = self.obj_to_output(of[:, :, None], g, delta=0.0)[:, :, 0]
        if self.scale_hd != 1:
            out = resize(out, self.scale_hd)
        return out

    def grid_to_bg_flow_from_ctx_to_ref(self, grids: WarpGrids, ctx_len, ref):
        """Background flow from every context frame to frame ``ref``,
        (B, Tc, Hd, Wd, 2)."""
        bg_flow = grids.tgt_bg[:, :ctx_len] - grids.tgt_bg[:, ref][:, None]  # B Tc H W 2
        src = grids.src_bg[:, ref][:, None].expand((-1, ctx_len) + tuple(grids.src_bg.shape[2:]))
        g = WarpGrids(None, None, None, src)
        out = self.bg_to_output(bg_flow, g, delta=0.0)[:, :, 0]
        if self.scale_hd != 1:
            out = resize(out, self.scale_hd)
        return out
