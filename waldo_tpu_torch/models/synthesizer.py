"""Synthesizer: LVD -> FLP -> WIF inference (counterpart of the predict path
of waldo_tpu/models/synthesizer.py).

Batch layout (channel-last): vid (B,T,Hd,Wd,3) in [-1,1], lyt
(B,T,Hd,Wd,Nl) scaled to {-5, 5}, flow (B,T,H,W,2). Only ``predict``
(vid_prediction) is ported; the training losses come with the training
slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..nn import init_module, resolve_dtype
from ..ops import resize
from ..utils.profiling import annotate
from .flp import FLPNet
from .lvd import LVDNet, bg_alpha_buffer, compute_occ
from .warper import Warper
from .wif import WIFNet


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"waldo_tpu_torch asks for device {str(dev)!r} (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run on "
            "the CPU")
    return dev


class Synthesizer:
    """Holds the nets (``lvd``, ``flp``, ``wif``, the JAX package's "pe",
    "pg" and "ii") and the parameterless warper on one device.

    Parameters are initialized from ``torch.Generator().manual_seed(seed)``
    with the JAX package's laws and zero-inits, or loaded from a JAX tree
    with ``waldo_tpu_torch.convert.from_jax``. The nets compute in
    ``cfg.compute_dtype``."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        self.cfg = cfg
        m = cfg.model
        self.device = _resolve_device(device)
        dtype = resolve_dtype(getattr(cfg, "compute_dtype", "float32"))
        gen = torch.Generator().manual_seed(seed)
        self.lvd = LVDNet(cfg, dtype) if m.use_pe else None
        self.flp = FLPNet(cfg, dtype) if m.use_pg else None
        self.wif = WIFNet(cfg, dtype) if m.use_ii else None
        for net in self.nets().values():
            init_module(net, gen)
            net.to(self.device).eval()
        self.warper = Warper(cfg, device=self.device)
        self.bg_alpha = torch.as_tensor(bg_alpha_buffer(cfg), device=self.device)

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The nets under the JAX package's parameter-tree keys."""
        nets = {"pe": self.lvd, "pg": self.flp, "ii": self.wif}
        return {k: v for k, v in nets.items() if v is not None}

    # ------------------------------------------------------------------
    # shared LVD pass
    # ------------------------------------------------------------------

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
