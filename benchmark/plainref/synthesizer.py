"""The reference's synthesizer: the port's ``Synthesizer.predict``
(vid_prediction) and ``extract_object_loss`` (the LVD training loss) with
their helpers, copied, on whole batches in one process.

Batch layout (channel-last): vid (B,T,Hd,Wd,3) in [-1,1], lyt
(B,T,Hd,Wd,Nl) scaled to {-5, 5}, flow (B,T,H,W,2). The nets are built
with empty parameters; the caller loads the weights (``load``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .models import FLPNet, LVDNet, Warper, WIFNet, bg_alpha_buffer, compute_occ
from .nn import resolve_dtype
from .ops import EdgeExtractor, gaussian_blur, resize
from .parallel import BatchShard, RowStream
from .utils.profiling import annotate

def compute_pts_regularization(pose, num_h, num_w):
    """Control-point grid smoothness, a 0-d tensor on pose's device; a grid
    with no interior points along an axis contributes 0 there."""
    pts = pose.reshape(-1, num_h, num_w, 2)
    reg = pose.new_zeros(())
    if num_h >= 3:
        reg = reg + ((pts[:, 1:-1] - 0.5 * (pts[:, 2:] + pts[:, :-2])) ** 2).mean()
    if num_w >= 3:
        reg = reg + ((pts[:, :, 1:-1] - 0.5 * (pts[:, :, 2:] + pts[:, :, :-2])) ** 2).mean()
    return reg


def _topk_mean(x, k, dim):
    """Mean of the k largest entries along dim."""
    return x.movedim(dim, -1).topk(k, dim=-1).values.mean(dim=-1)



class Reference:
    """The nets ``lvd``, ``flp`` and ``wif`` (the port's "pe", "pg", "ii")
    and the parameterless warper on one device, in ``cfg.compute_dtype``.
    With ``meta`` the nets hold no memory: they give the parameters' names,
    shapes and laws."""

    def __init__(self, cfg, device, meta: bool = False):
        self.cfg = cfg
        m = cfg.model
        self.device = torch.device(device)
        dtype = resolve_dtype(getattr(cfg, "compute_dtype", "float32"))
        with torch.device("meta" if meta else "cpu"):  # the parameters come with load()
            self.lvd = LVDNet(cfg, dtype) if m.use_pe else None
            self.flp = FLPNet(cfg, dtype) if m.use_pg else None
            self.wif = WIFNet(cfg, dtype) if m.use_ii else None
        for net in self.nets().values():
            net.eval()
        self.warper = Warper(cfg, device=self.device)
        self.edge = EdgeExtractor(kernel_size=m.edge_size)
        d = cfg.data
        self.lyt_idx = {k: torch.tensor(v, dtype=torch.long, device=self.device)
                        for k, v in (("fg", d.fg_idx), ("bg", d.bg_idx), ("other", d.other_idx))}
        self.bg_alpha = torch.as_tensor(bg_alpha_buffer(cfg), device=self.device)

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The nets under the port's parameter-tree keys."""
        nets = {"pe": self.lvd, "pg": self.flp, "ii": self.wif}
        return {k: v for k, v in nets.items() if v is not None}

    def load(self, params: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Take the parameters of each net ({net: {name: tensor}}) as they
        are, on this device; every parameter of the nets is given."""
        for key, net in self.nets().items():
            given = params[key]
            names = {n for n, _ in net.named_parameters()}
            if names != set(given):
                raise KeyError(f"{key}: parameters {sorted(names ^ set(given))[:4]} differ")
            for name, value in given.items():
                mod, _, leaf = name.rpartition(".")
                owner = net.get_submodule(mod) if mod else net
                setattr(owner, leaf, torch.nn.Parameter(value, requires_grad=value.requires_grad))
            net.to(self.device)  # the buffers the constructors computed


    def make_input(self, vid, lyt, flow):
        m = self.cfg.model
        parts = []
        if m.input_rgb:
            parts.append(vid)
        if m.input_lyt:
            parts.append(lyt)
        if m.input_flow:
            f = flow
            if tuple(f.shape[-3:-1]) != tuple(vid.shape[-3:-1]):
                f = resize(f, shape=tuple(vid.shape[-3:-1]))
            parts.append(f)
        return torch.cat(parts, dim=-1)

    def lvd_pass(self, real_input, ctx_len):
        with annotate("lvd/encode_input"):
            x = self.lvd.encode_input(real_input)
        with annotate("lvd/estimate_layer"):
            x_obj, x_bg, cls = self.lvd.estimate_layer(x[:, :ctx_len])
        with annotate("lvd/estimate_pose"):
            (obj_pose, bg_pose, occ_score, rest_o, rest_b, last_o, last_b) = (
                self.lvd.estimate_pose(x, x_obj, x_bg))
        return dict(
            x=x, x_obj=x_obj, x_bg=x_bg, cls=cls,
            obj_pose=obj_pose, bg_pose=bg_pose, occ_score=occ_score,
            rest_obj=rest_o, rest_bg=rest_b, last_obj=last_o, last_bg=last_b,
        )

    def alpha_grid_occ(self, x_obj, obj_pose, bg_pose, occ_score):
        with annotate("lvd/decode_alpha"):
            obj_alpha = self.lvd.decode_obj_alpha(x_obj)
        b = x_obj.shape[0]
        bg_alpha = self.bg_alpha.expand((b,) + tuple(self.bg_alpha.shape[1:]))
        with annotate("warper/grids"):
            grids = self.warper(obj_pose, bg_pose[:, :, 0])
        occ = compute_occ(occ_score)
        return occ, obj_alpha, bg_alpha, grids

    def decode_layer(self, real_input, grids, occ, obj_alpha, bg_alpha, generator=None,
                     draws=None):
        """The layers' textures: the input (B,T,H,W,C) gathered into each
        layer's frame, reduced over time by the occlusion-aware alphas
        (obj (B,No,Ho,Wo,C+1), bg (B,H,W,C+1)), and the output alphas
        (B,T,No+1,H,W,1). Time dropout when ``generator`` or ``draws`` is
        given (``models.lvd.reduce_time``)."""
        obj, bg = self.warper.layer_from_input(real_input, grids)
        occ_obj_alpha, occ_bg_alpha, output_alpha = self.warper.alpha_to_alpha(
            obj_alpha, bg_alpha, grids, occ)
        obj, bg = reduce_time(obj, bg, occ_obj_alpha, occ_bg_alpha, generator=generator,
                              draws=draws)
        return obj, bg, output_alpha

    def decode_output(self, real_input, grids, occ, obj_alpha, bg_alpha, cls,
                      ctx_ts, pred_ts, restrict_to_ctx=None, hd_window=None,
                      ctx_uniform=False):
        m = self.cfg.model
        if restrict_to_ctx is None:
            restrict_to_ctx = m.restrict_to_ctx
        with annotate("warper/grid_to_flow"):
            flow, alpha_unflt, alpha, alpha_ctx, disocc = self.warper.grid_to_flow(
                real_input, grids, occ, obj_alpha, bg_alpha, cls, ctx_ts, pred_ts,
                restrict_to_ctx=restrict_to_ctx, hd_window=hd_window,
                ctx_uniform=ctx_uniform)
        with annotate("warper/input_to_output"):
            output, raw_output = self.warper.input_to_output(
                real_input, alpha_ctx, flow, ctx_ts, ctx_uniform=ctx_uniform)
        raw_alpha = output[..., -1:]
        if m.use_disocc:
            if m.include_self:
                disocc = torch.cat([disocc, torch.ones_like(disocc[:, :1])], dim=1)
            raw_output = torch.cat([raw_output, disocc.to(raw_output.dtype)], dim=-1)
        output = output[..., :-1]
        return output, flow, alpha_unflt, alpha, raw_alpha, raw_output, alpha_ctx

    def _ctx_ts(self, b, t, stream: RowStream):
        """Context-time indices (B, Tc, T) by ctx_mode: every frame ("full"),
        the previous frame ("prev"; frame 0's is the last), or the previous
        one plus rd_ctx_num random ones ("prev_rd", drawn from
        ``stream``)."""
        m = self.cfg.model
        dev = self.device
        if m.ctx_mode == "full":
            return torch.arange(t, device=dev)[None, :, None].expand(b, t, t)
        if m.ctx_mode not in ("prev", "prev_rd"):
            raise ValueError(f"unknown ctx_mode {m.ctx_mode!r}")
        ts = torch.roll(torch.arange(t, device=dev), 1)[None, None].expand(b, 1, t)
        if m.ctx_mode == "prev_rd":
            rd = stream.randint(0, t, (b, m.rd_ctx_num, t), dev)
            ts = torch.cat([ts, rd], dim=1)
        return ts

    def extract_object_loss(self, batch, global_iter=0, is_img=False,
                            generator: Optional[torch.Generator] = None,
                            shard: Optional[BatchShard] = None):
        """The LVD training loss. batch {"vid", "lyt", "flow"} on this
        synthesizer's device, the rows ``shard`` says of the global batch;
        ``generator`` (a torch.Generator on that device) draws the
        input-modality dropout (drop_input_p) and the random contexts of
        ctx_mode "prev_rd", the only random parts. Returns (loss, metrics),
        every metric a detached 0-d tensor; the loss is differentiable in
        the LVD parameters."""
        cfg, m = self.cfg, self.cfg.model
        if m.dropout > 0:
            raise NotImplementedError(
                "LVD dropout in training is refused as in the JAX package, where flax raises "
                "InvalidRngError ('Dropout_0 needs PRNG for \"dropout\"'): its lvd_pass runs "
                "the LVD with deterministic=False and no \"dropout\" rng "
                "(waldo_tpu/models/synthesizer.py:173-183); at inference dropout is the identity")
        losses = m.vid_object_extractor_losses
        vid, lyt, flow = batch["vid"], batch["lyt"], batch["flow"]
        if is_img:
            vid, lyt, flow = vid[:, None], lyt[:, None], flow[:, None]
        b, t = vid.shape[:2]
        ctx_len = 1 if is_img else m.ctx_len
        dev = vid.device
        shard = shard or BatchShard.whole(b)
        stream = RowStream(generator, shard)
        metrics = {}

        # input-modality dropout
        if m.drop_input_p > 0:
            keep = [stream.rand((b, t), dev) > m.drop_input_p for _ in range(3)]
            mul_rgb, mul_lyt, mul_flow = keep
            if m.input_rgb:
                mul_rgb = ((~mul_flow) & (~mul_lyt) & (~mul_rgb)) | mul_rgb
            elif m.input_flow:
                mul_flow = ((~mul_flow) & (~mul_lyt)) | mul_flow
            r = lambda k: k[:, :, None, None, None].to(vid.dtype)
            vid_in, lyt_in, flow_in = vid * r(mul_rgb), lyt * r(mul_lyt), flow * r(mul_flow)
        else:
            vid_in, lyt_in, flow_in = vid, lyt, flow

        real_input = self.make_input(vid_in, lyt_in, flow_in)
        p = self.lvd_pass(real_input, ctx_len)
        occ, obj_alpha, bg_alpha, grids = self.alpha_grid_occ(
            p["x_obj"], p["obj_pose"], p["bg_pose"], p["occ_score"])

        decode_input = torch.cat([vid, lyt], dim=-1)
        ctx_ts = self._ctx_ts(b, t, stream)
        pred_ts = torch.arange(t, device=dev)
        rec_output, flow_full, alpha_unflt, alpha_flt, _, _, _ = self.decode_output(
            decode_input, grids, occ, obj_alpha, bg_alpha, p["cls"], ctx_ts, pred_ts,
            restrict_to_ctx=False)

        # reconstructed flow from the previous frame
        if m.ctx_mode == "full":
            idx = torch.arange(t - 1, device=dev)
            rec_flow = flow_full[:, :, 1:][:, idx, idx]
        else:
            rec_flow = flow_full[:, 0, 1:]  # B T-1 Hd Wd 2

        rec_vid, rec_lyt = rec_output[..., :3], rec_output[..., 3:]
        rec_output_alpha = alpha_flt if m.swap_flt else alpha_unflt  # B T Hd Wd No+1
        nll = torch.zeros((), device=dev)

        def add(name, weight):
            nonlocal nll
            nll = nll + metrics[name] * weight

        with annotate("loss/regularizers"):
            # per-layer mean-flow consistency
            a = (rec_output_alpha[..., 1:] + 1) / 2 + 1e-6  # B T H W No
            sum_a = a.sum(dim=(2, 3))  # B T No
            mean_flow = torch.einsum("bthwc,bthwn->btnc", flow, a) / sum_a[..., None]
            diff = (flow[:, :, :, :, None, :] - mean_flow[:, :, None, None]).abs()
            metrics["obj_flow"] = (a * diff.sum(-1)).mean()
            if "obj_flow" in losses:
                add("obj_flow", m.lambda_obj_flow)

            # cluster activity, over the global batch: each clip's mean per
            # object, gathered from the ranks
            cs = a - 1e-6
            k = max(m.num_obj // 4, 1)
            per_b = shard.gather(-cs.reshape(b, -1, m.num_obj).mean(1))  # B No
            metrics["activity"] = _topk_mean(per_b.mean(0), k, 0).mean()
            top_b = per_b.topk(max(shard.total // 4, 1), dim=0).values  # kb No
            metrics["topactivity"] = _topk_mean(top_b, k, 1).mean()
            mul_img = m.img_mul_act_reg if is_img else 1.0
            if "activity" in losses:
                add("activity", m.lambda_activity * mul_img)
            if "topactivity" in losses:
                add("topactivity", m.lambda_activity * mul_img)

            # entropies
            def entropy_of(alpha_pm1):
                p01 = (alpha_pm1 + 1) / 2 + 1e-6
                p01 = p01 / p01.sum(-1, keepdim=True)
                return -(p01 * torch.log(p01 + 1e-6)).sum(-1, keepdim=True) / 0.37

            entropy = entropy_of(rec_output_alpha)
            entropy_flt = entropy_of(alpha_flt)
            lyt_edge_mask = (gaussian_blur(lyt / 10 + 0.5, sigma=2.0, kernel_size=3)
                             .amax(-1, keepdim=True) > 0.999).to(vid.dtype)
            metrics["ent"] = entropy.mean()
            metrics["ent_flt"] = entropy_flt.mean()
            metrics["ent_flt_edge"] = (entropy_flt * lyt_edge_mask).mean()
            for name in ("ent", "ent_flt", "ent_flt_edge"):
                if name in losses:
                    add(name, getattr(m, f"lambda_{name}"))

        with annotate("loss/moving_objects"):
            mov_obj_mask, fg_prop, nobg_prop, flow_edge_bin = self._moving_objects(lyt, flow)
            fg_mask = ((rec_output_alpha[..., 1:] + 1) / 2).sum(-1, keepdim=True)
            found_obj = -fg_mask
            mov_obj = mov_obj_mask * 2 - 1
            mov_obj = torch.where(mov_obj < 0, mov_obj * m.reg_bg_mul, mov_obj)
            zero = mov_obj.new_zeros(())
            if m.use_fg:
                mov_obj = torch.where((mov_obj < 0) & (fg_prop > 0), zero, mov_obj)
            if m.use_nobg:
                mov_obj = torch.where((mov_obj < 0) & (nobg_prop > 0), zero, mov_obj)
            if m.use_nobg_edge:
                mov_obj = torch.where((mov_obj < 0) & (nobg_prop > 0) & (flow_edge_bin > 0.1),
                                      mov_obj.new_full((), m.nobg_edge_mul), mov_obj)
            if m.blur_alpha:
                found_obj = gaussian_blur(found_obj, m.blur_sigma)
                mov_obj = gaussian_blur(mov_obj, m.blur_sigma)
            metrics["abs_mov"] = (mov_obj_mask - fg_mask).abs().mean()
            metrics["reg_mov"] = (mov_obj * found_obj).mean()
            metrics["reg_fg"] = (-found_obj * (1 - fg_prop)).mean()
            if "abs_mov" in losses:
                add("abs_mov", m.lambda_abs_mov)
            if "reg_mov" in losses:
                wm, wi = m.warmup_reg_mov_mul, m.warmup_reg_mov_iter
                mul = max(1.0, wm * (1 - global_iter / wi)) if wi > 0 else 1.0
                add("reg_mov", m.lambda_reg_mov * mul * mul_img)
            if "reg_fg" in losses:
                add("reg_fg", m.lambda_reg_fg)

        with annotate("loss/cell_dis"):
            self._cell_dis(metrics, p["obj_pose"], mov_obj_mask, fg_mask, b, t,
                           tuple(vid.shape[2:4]))
            if "cell_dis" in losses:
                add("cell_dis", m.lambda_cell_dis)
            if "center_dis" in losses:
                add("center_dis", m.lambda_center_dis)

        with annotate("loss/reconstruction"):
            metrics["l1_flow"] = (flow[:, 1:] - rec_flow).abs().mean()
            if "l1_flow" in losses:
                wm, wi = m.warmup_l1_flow_mul, m.warmup_l1_flow_iter
                mul = min(float(wm), 1 + (wm - 1) * (global_iter / wi)) if wi > 0 else 1.0
                add("l1_flow", m.lambda_l1_flow * mul)

            # layout cross-entropy
            tgt = lyt.argmax(dim=-1, keepdim=True)
            logp = torch.log_softmax(rec_lyt, dim=-1)
            metrics["ce_lyt"] = (-logp.gather(-1, tgt)[..., 0]).mean()
            logp_obj = torch.log_softmax(fg_mask * rec_lyt, dim=-1)
            ce_obj = -logp_obj.gather(-1, tgt)[..., 0]
            metrics["ce_lyt_obj"] = (ce_obj * mov_obj_mask[..., 0]).mean()
            metrics["soft_ce_lyt"] = (-((lyt / 10 + 0.5) * logp).sum(-1)).mean()
            for name in ("ce_lyt", "ce_lyt_obj", "soft_ce_lyt"):
                if name in losses:
                    add(name, getattr(m, f"lambda_{name}"))

            # pixel reconstruction
            metrics["sharp_vid"] = (rec_vid - vid).abs().mean()
            rv, fv = vid, rec_vid
            if m.blur_pxl:
                rv, fv = gaussian_blur(vid, m.blur_sigma), gaussian_blur(rec_vid, m.blur_sigma)
            pxl = rv - fv
            pxl = (pxl.abs() if m.l1_pxl else pxl ** 2).reshape(b, -1).mean(-1)
            metrics["pxl_vid"] = pxl.mean()
            if "pxl_vid" in losses:
                wi = m.warmup_pxl_vid_iter
                mul = min(1.0, global_iter / wi) if wi > 0 else 1.0
                if m.cosine_warmup_pxl_vid:
                    mul = math.sin(mul * math.pi / 2)
                add("pxl_vid", m.lambda_pxl_vid * mul)
            if "sharp_vid" in losses:
                wi = m.warmup_sharp_vid_iter
                mul = min(1.0, global_iter / wi) if wi > 0 else 1.0
                add("sharp_vid", m.lambda_sharp_vid * mul)

        # grid regularization and rest pose
        metrics["pts_reg_obj"] = compute_pts_regularization(p["obj_pose"], *m.obj_shape)
        if "pts_reg_obj" in losses:
            add("pts_reg_obj", m.lambda_pts_reg)
        if m.has_bg:
            metrics["pts_reg_bg"] = compute_pts_regularization(p["bg_pose"], *m.latent_shape)
            if "pts_reg_bg" in losses:
                add("pts_reg_bg", m.lambda_pts_reg)

        def rest(r):
            if m.ada_pts_rest:
                return (r * pxl[:, None]).mean()
            if m.ada_pts_rest_detach:
                return (r * pxl.detach()[:, None]).mean()
            return r.mean()

        metrics["pts_rest_obj"] = rest(p["rest_obj"])
        if m.has_bg and not m.fix_bg:
            metrics["pts_rest_bg"] = rest(p["rest_bg"])
        if "pts_rest_obj" in losses:
            add("pts_rest_obj", m.lambda_pts_rest)
        if "pts_rest_bg" in losses and "pts_rest_bg" in metrics:
            add("pts_rest_bg", m.lambda_pts_rest)

        metrics["loss"] = nll
        return nll, {k: v.detach() for k, v in metrics.items()}

    def _moving_objects(self, lyt, flow):
        """The data's moving-object mask (B,T,H,W,1) from the flow edges and
        the layout, and the layout's foreground and non-background shares;
        no parameter enters it."""
        m = self.cfg.model
        dt = flow.dtype
        prop = lambda k: (lyt.index_select(-1, self.lyt_idx[k]) / 10 + 0.5).sum(-1, keepdim=True)
        flow_edge, dominant = self.edge(flow)
        flow_edge_bin = (flow_edge > m.flow_thresh).to(dt)
        fg_prop = prop("fg")
        nofg_prop = 1 - fg_prop
        nobg_prop = 1 - prop("bg")
        nofg_flow = gaussian_blur(torch.cat([nofg_prop, nofg_prop * flow], dim=-1), m.blur_sigma)
        denom = nofg_flow[..., :1] + (nofg_flow[..., :1] == 0).to(dt)
        mean_bg_flow = nofg_flow[..., 1:] / denom
        delta_flow = fg_prop * (flow - mean_bg_flow).abs().sum(-1, keepdim=True)
        mov_obj_mask = (delta_flow > m.mov_obj_thresh).to(dt)
        if m.use_dominant_flow_other:
            other = prop("other") * dominant * flow_edge_bin
            mov_obj_mask = torch.maximum(mov_obj_mask, other)
        if m.use_flow_nobg:
            fm = (flow_edge_bin > 0.1) & (nobg_prop > 0)
            mov_obj_mask = torch.maximum(mov_obj_mask, fm.to(dt))
        return mov_obj_mask, fg_prop, nobg_prop, flow_edge_bin

    def _cell_dis(self, metrics, obj_pose, mov_obj_mask, fg_mask, b, t, hd_shape):
        """Control-point cell and centre distances to the moving pixels not
        yet covered: cell_dis sums the squared distance to each of the
        object grid's cell centres, taken as sum_k |p_k|^2 + K |g|^2 -
        2 g . sum_k p_k (the (B,T,No,cells,H,W) distances never
        materialize)."""
        m = self.cfg.model
        grid = self.warper.src_grid
        grid_hd = grid if tuple(grid.shape[:2]) == hd_shape else self.warper.src_grid_hd
        ho_, wo_ = m.obj_shape
        obj_grid = obj_pose.reshape(b, t, m.num_obj, ho_, wo_, 2)
        obj_cell = (obj_grid[:, :, :, 1:, 1:] + obj_grid[:, :, :, 1:, :-1]
                    + obj_grid[:, :, :, :-1, 1:] + obj_grid[:, :, :, :-1, :-1]) / 4
        cells = obj_cell.reshape(b, t, m.num_obj, -1, 2)  # B T No K 2
        obj_center = obj_grid.reshape(b, t, m.num_obj, -1, 2).mean(3)  # B T No 2
        g2 = (grid_hd ** 2).sum(-1)  # H W
        dot = lambda pts: torch.einsum("btnc,hwc->btnhw", pts, grid_hd)
        cell_dis = (cells.shape[3] * g2 + (cells ** 2).sum((-1, -2))[..., None, None]
                    - 2 * dot(cells.sum(3)))  # B T No H W
        center_dis = g2 + (obj_center ** 2).sum(-1)[..., None, None] - 2 * dot(obj_center)
        mv, fm = mov_obj_mask, fg_mask
        if m.blur_alpha:
            mv, fm = gaussian_blur(mv, m.blur_sigma), gaussian_blur(fm, m.blur_sigma)
        mv_l, fm_l = mv.movedim(-1, 2), fm.movedim(-1, 2)  # B T 1 H W
        metrics["cell_dis"] = ((mv_l + m.cell_dis_eps) * (1 - fm_l) * cell_dis).amin(dim=2).mean()
        metrics["center_dis"] = (mv_l * center_dis).amin(dim=2).mean()

    # ------------------------------------------------------------------
    # vid_prediction
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """Full pipeline inference. batch: {"vid", "lyt", "flow"} tensors on
        this synthesizer's device. Returns videos (B,T*,Hd,Wd,3) and the
        prediction's flows, grids and alpha maps."""
        m = self.cfg.model
        vid, lyt, flow = batch["vid"], batch["lyt"], batch["flow"]
        b, t = vid.shape[:2]
        ctx_len = m.ctx_len
        dev = vid.device

        real_input = self.make_input(vid, lyt, flow)
        p = self.lvd_pass(real_input, ctx_len)
        occ, obj_alpha, bg_alpha, grids = self.alpha_grid_occ(
            p["x_obj"], p["obj_pose"], p["bg_pose"], p["occ_score"])

        decode_input = torch.cat([vid, lyt], dim=-1)
        ctx_ts = torch.arange(ctx_len, device=dev)[None, :, None].expand(b, ctx_len, t)
        if m.last_n_ctx > 0:
            ctx_ts = ctx_ts[:, -m.last_n_ctx:]
        pred_ts = torch.arange(t, device=dev)
        rec_output, _, _, _, _, raw_output, _ = self.decode_output(
            decode_input, grids, occ, obj_alpha, bg_alpha, p["cls"], ctx_ts, pred_ts,
            restrict_to_ctx=m.restrict_to_ctx, hd_window=ctx_len, ctx_uniform=True)
        out = {"real_vid": vid, "rec_vid": rec_output[..., :3]}

        if m.use_ii:
            with annotate("wif/fuse_rec"):
                out["inp_rec_vid"] = self.wif(raw_output)

        if m.use_pg and not m.no_future:
            ctx_mask = (torch.arange(t, device=dev)[None, :] < ctx_len).expand(b, t)
            with annotate("flp/rollout"):
                pred_obj, pred_bg, pred_occ = self.flp(
                    p["obj_pose"], p["bg_pose"], p["occ_score"], p["x_obj"], p["x_bg"],
                    p["last_obj"], p["last_bg"], ctx_mask)
            occ2, obj_alpha2, bg_alpha2, grids2 = self.alpha_grid_occ(
                p["x_obj"], pred_obj, pred_bg, pred_occ)
            pred_ts2 = torch.arange(ctx_len, t, device=dev)
            ctx_ts2 = torch.arange(ctx_len, device=dev)[None, :, None].expand(
                b, ctx_len, t - ctx_len)
            pred_output, pred_flow, _, alpha2, _, raw_output2, alpha_ctx2 = (
                self.decode_output(decode_input, grids2, occ2, obj_alpha2, bg_alpha2,
                                   p["cls"], ctx_ts2, pred_ts2,
                                   restrict_to_ctx=m.restrict_to_ctx,
                                   hd_window=ctx_len, ctx_uniform=True))
            out["pred_vid"] = torch.cat([vid[:, :ctx_len], pred_output[..., :3]], dim=1)
            if m.use_ii:
                with annotate("wif/fuse_pred"):
                    inp_pred = self.wif(raw_output2)
                out["inp_pred_vid"] = torch.cat([vid[:, :ctx_len], inp_pred], dim=1)
            out["pred_flow"] = pred_flow
            out["pred_grids"] = grids2
            out["pred_alpha"] = alpha2
            out["pred_alpha_ctx"] = alpha_ctx2
            out["pred_raw_output"] = raw_output2
        return out
