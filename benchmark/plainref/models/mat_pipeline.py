"""The plain MAT post-process of the predicted video: WALDO's
``inpaint_with_mat`` (github.com/16lemoing/waldo) on test_mat.sh's path
(``loop_ii`` with object inpainting and propagation; the port's other
branches are left out) as the port's ``models/mat_pipeline.py`` runs it,
copied, and its inpainter.

``MatInpainter`` runs the plain ``Generator`` (``models/mat.py``) as the
port's does: a 512x1024 frame as three 512x512 crops at offsets 0, 256 and
512, blended by triangular weights (1 to 100 and back) and pasted into the
hole; the hole dilated 3 times (4-neighbourhood) before the net sees it;
truncation 0.5; each crop's z a (B, 512) normal draw from ``generator``, a
``torch.Generator`` on the device. Setting that generator's state to the
program's at the start of a clip replays every z the program drew in it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops import grid_sample, resize
from .mat import Generator


def expand_mask(mask: torch.Tensor, num: int = 1) -> torch.Tensor:
    """Binary 4-neighbourhood dilation of (..., H, W, 1) masks, ``num`` times."""
    lead = tuple(mask.shape[:-3])
    h, w, c = mask.shape[-3:]
    m = (mask > 0.5).reshape(-1, h, w, c)
    for _ in range(num):
        m = (m | F.pad(m[:, :-1], (0, 0, 0, 0, 1, 0)) | F.pad(m[:, 1:], (0, 0, 0, 0, 0, 1))
             | F.pad(m[:, :, :-1], (0, 0, 1, 0)) | F.pad(m[:, :, 1:], (0, 0, 0, 1)))
    return m.reshape(lead + (h, w, c)).to(mask.dtype)


def soft_expand(mask: torch.Tensor, num: int = 1, alpha: float = 0.97) -> torch.Tensor:
    """Soft directional max-dilation of (B, H, W, C) masks."""
    for _ in range(num):
        south = F.pad(mask[:, :-1], (0, 0, 0, 0, 1, 0))
        north = F.pad(mask[:, 1:], (0, 0, 0, 0, 0, 1))
        east = F.pad(mask[:, :, :-1], (0, 0, 1, 0))
        west = F.pad(mask[:, :, 1:], (0, 0, 0, 1))
        mask = torch.maximum(mask, alpha * torch.maximum(torch.maximum(south, north),
                                                         torch.maximum(east, west)))
    return mask


def point_in_polygon(pts: torch.Tensor, corners) -> torch.Tensor:
    """Ray casting: pts (B, H, W, 2) pixel coordinates, corners [(x, y)] ->
    (B, H, W, 1) in pts' dtype."""
    x, y = pts[..., 0], pts[..., 1]
    inside = torch.zeros(x.shape, dtype=torch.bool, device=pts.device)
    for i in range(len(corners)):
        x1, y1 = corners[i]
        x2, y2 = corners[(i + 1) % len(corners)]
        inside = inside ^ (((y1 > y) != (y2 > y))
                           & (x < (x2 - x1) * (y - y1) / (y2 - y1 + 1e-12) + x1))
    return inside[..., None].to(pts.dtype)


class MatInpainter:
    """The plain MAT at ``resolution`` on ``device``, its state from ``load``."""

    def __init__(self, device, resolution: int = 512):
        self.res = resolution
        self.device = torch.device(device)
        with torch.device("meta"):
            self.net = Generator(img_resolution=resolution).eval()
        self.generator = torch.Generator(device=self.device)
        self.calls = 0

    def load(self, state: Dict[str, torch.Tensor]) -> None:
        """Every parameter and buffer of the net under the port's names (the
        resampling filters are the constructors'), as given; parameters ask
        for gradients, as the program's do."""
        net = self.net
        names = {n for n, _ in net.named_parameters()} | {
            n for n, _ in net.named_buffers() if not n.endswith("resample_filter")}
        if names != set(state):
            raise KeyError(f"MAT state: {sorted(names ^ set(state))[:4]} differ")
        for name, value in state.items():
            mod, _, leaf = name.rpartition(".")
            owner = net.get_submodule(mod) if mod else net
            v = value.detach().to(self.device).clone()
            if leaf in owner._parameters:
                setattr(owner, leaf, torch.nn.Parameter(v, requires_grad=True))
            else:
                owner.register_buffer(leaf, v)
        net.to(self.device)  # the filters

    def _apply(self, x, keep):
        self.calls += 1
        z = torch.randn((x.shape[0], 512), generator=self.generator, device=self.device)
        return self.net(x, keep, z, truncation_psi=0.5)

    @torch.inference_mode()
    def __call__(self, x, mask):
        """x (B, H, W, 3) in [-1, 1], mask (B, H, W, 1) with 1 = hole; H x W
        is resized to res x 2 res."""
        x, mask = x.float(), mask.float()
        b, h, w, _ = x.shape
        size = (self.res, 2 * self.res)
        xi, mi = x, mask
        if (h, w) != size:
            xi = resize(x, shape=size)
            mi = (resize(mask, shape=size) > 0.5).to(x.dtype)
        x2, c = torch.zeros_like(xi), torch.zeros_like(mi)
        half = self.res // 2
        tri = torch.cat([torch.linspace(1, 100, half, device=x.device),
                         torch.linspace(100, 1, half, device=x.device)]).reshape(1, 1, -1, 1)
        for i in range(3):
            s = half * i
            m = expand_mask(mi[:, :, s: s + self.res], 3)
            x2[:, :, s: s + self.res] += self._apply(
                xi[:, :, s: s + self.res].contiguous(), (1 - m).contiguous()) * tri
            c[:, :, s: s + self.res] += tri
        out = x2 / c * mi + xi * (1 - mi)
        return resize(out, shape=(h, w)) if (h, w) != size else out


def _warp(img, flow, src_grid):
    return grid_sample(img, flow + src_grid[None])


@torch.inference_mode()
def inpaint_with_mat(cfg, warper, wif_apply, inpainter, raw_output, alpha, alpha_ctx, real_vid,
                     pred_flow, ctx_len, grids):
    """test_mat.sh's post-process, all videos channel-last: raw_output
    (B,Tc',Tp,Hd,Wd,C'), alpha (B,Tp,Hd,Wd,No+1), alpha_ctx
    (B,Tc,Tp,Hd,Wd,No+1), real_vid (B,T,Hd,Wd,3), pred_flow
    (B,Tc,Tp,Hd,Wd,2); ``wif_apply`` maps a raw stack to fused frames.
    Returns inp_pred_vid (B,T,Hd,Wd,3)."""
    m = cfg.model
    src_grid = warper.src_grid_hd
    hd, wd = src_grid.shape[:2]
    b, _, tp = raw_output.shape[:3]
    mask_thresh = 0.1
    shadow_mask = None
    a01 = (alpha_ctx + 1) / 2

    if not (m.use_inpainter and m.loop_ii and m.inpaint_obj and m.propagate_unique) or m.fix_mask:
        raise ValueError("the plain chain runs test_mat.sh's path: use_inpainter, loop_ii, "
                         "inpaint_obj and propagate_unique, without fix_mask")
    cov = a01.sum(-1)
    mask = (1 - (cov[:, -1] if m.ii_last_only else cov.amax(dim=1)))[..., None]
    mask = ((mask > mask_thresh) if m.fix_thresh else (mask > 1 - mask_thresh)).float()
    obj_cov = a01[..., 1:].sum(-1)
    obj_mask = (obj_cov[:, -1] if m.ii_last_only else obj_cov.amax(dim=1))[..., None]
    obj_mask = (obj_mask > 0.9).float()
    if m.use_expansion:
        mask = expand_mask(mask, num=m.num_expansion) * (1 - obj_mask)

    inp_frames = [wif_apply(raw_output[:, :, t: t + 1])[:, 0] for t in range(tp)]
    ref = -1
    ref_to_pred_bg = warper.grid_to_bg_flow_from_ref_to_pred(grids, ctx_len, ref)
    ctx_to_ref_bg = warper.grid_to_bg_flow_from_ctx_to_ref(grids, ctx_len, ref)
    ref_img = inp_frames[ref]
    obj_mask_ref = obj_mask[:, ref]
    ref_left = ref_right = None

    # the background gathered from the context frames
    for t2 in range(ctx_len - 1, -1, -1):
        ctx_mask = (alpha[..., :1][:, t2] > 1 - mask_thresh).float()
        warped_img = _warp(real_vid[:, t2], ctx_to_ref_bg[:, t2], src_grid)
        warped_mask = (_warp(ctx_mask, ctx_to_ref_bg[:, t2], src_grid) > 1 - mask_thresh).float()
        if m.use_shadows and t2 == ctx_len - 1:
            sm = ((warped_img - ref_img).abs().mean(-1, keepdim=True) > 0.25)
            sm = sm.float() * warped_mask * (1 - obj_mask_ref)
            sm = expand_mask(1 - expand_mask(1 - sm, num=5), num=5)
            sm[:, : int(sm.shape[1] * 0.4)] = 0.0
            shadow_mask = soft_expand(sm, num=30) if m.soft_shadow else expand_mask(sm, num=30)
        inter = obj_mask_ref * warped_mask
        ref_img = inter * warped_img + (1 - inter) * ref_img
        obj_mask_ref = (1 - inter) * obj_mask_ref
        if m.ii_last_only:
            break

    # the reference frame inpainted
    ref_mask = 1 - (1 - mask[:, ref]) * (1 - obj_mask_ref)
    ref_img = inpainter((1 - mask[:, ref]) * (1 - obj_mask_ref) * ref_img, ref_mask)

    # objects entering from the left or right border, decided on the host
    if m.propagate_obj:
        border = 3
        pred_grid = (pred_flow[:, -1, -1] + src_grid[None]).float().cpu().numpy().copy()
        pred_grid[..., 0] = (pred_grid[..., 0] * wd + wd - 1) / 2
        pred_grid[..., 1] = (pred_grid[..., 1] * hd + hd - 1) / 2
        orig = src_grid.float().cpu().numpy().copy()[None]
        orig[..., 0] = (orig[..., 0] * wd + wd - 1) / 2
        orig[..., 1] = (orig[..., 1] * hd + hd - 1) / 2
        all_obj = (((alpha_ctx[:, :, -1, :, :, 1:] + 1) / 2).amax(dim=1) > 0.9).cpu().numpy()
        is_left_obj = (pred_grid[..., 0] < border)[..., None] & all_obj
        is_right_obj = (pred_grid[..., 0] >= wd - border)[..., None] & all_obj
        orig_t = torch.as_tensor(orig, device=src_grid.device)

        def complete(side_obj, side):
            oid = int(side_obj.reshape(b, -1, side_obj.shape[-1]).sum(1).argmax(1)[0])
            sel = side_obj[..., oid]
            bv, ovs = pred_grid[sel], orig[0][sel[0]]
            if side == "left":
                corners = [(0, float(bv[:, 1].min())), (0, float(bv[:, 1].max())),
                           (float(ovs[:, 0].max()), float(ovs[:, 1].max())),
                           (float(ovs[:, 0].max()), float(ovs[:, 1].min()))]
            else:
                corners = [(float(ovs[:, 0].min()), float(ovs[:, 1].min())),
                           (float(ovs[:, 0].min()), float(ovs[:, 1].max())),
                           (wd - 1, float(bv[:, 1].max())), (wd - 1, float(bv[:, 1].min()))]
            pmask = point_in_polygon(orig_t, corners)
            obj_fill = inpainter((1 - pmask) * raw_output[:, -1, -1, :, :, :3], pmask)
            return pmask, obj_fill, warper.grid_to_obj_flow_from_ref_to_pred(grids, ctx_len, ref,
                                                                            oid)

        if is_left_obj.sum() > 0:
            ref_left = complete(is_left_obj, "left")
        if is_right_obj.sum() > 0:
            ref_right = complete(is_right_obj, "right")

    # the inpainted reference warped forward to each predicted frame
    out_frames = []
    for t in range(tp):
        img, curr_mask = inp_frames[t], mask[:, t]
        warped_img = _warp(ref_img, ref_to_pred_bg[:, t], src_grid)
        warped_mask = (_warp(ref_mask, ref_to_pred_bg[:, t], src_grid) > 1 - mask_thresh).float()
        for side in (ref_left, ref_right):
            if side is None:
                continue
            smask, sobj, sflow = side
            w_obj = _warp(sobj, sflow[:, t], src_grid)
            w_m = (_warp(smask, sflow[:, t], src_grid) > 1 - mask_thresh).float()
            warped_mask = 1 - (1 - warped_mask) * (1 - w_m)
            curr_mask = 1 - (1 - curr_mask) * (1 - w_m)
            warped_img = (1 - w_m) * warped_img + w_m * w_obj
        obj_mask_t = obj_mask[:, t]
        if m.use_shadows and shadow_mask is not None:
            wsm = _warp(shadow_mask, ref_to_pred_bg[:, t], src_grid)
            if not m.soft_shadow:
                wsm = (wsm > 1 - mask_thresh).float()
            curr_mask = curr_mask * (1 - wsm * (1 - obj_mask_t))
        inter = curr_mask * warped_mask
        img = inter * warped_img + (1 - inter) * img
        curr_mask = (1 - inter) * curr_mask
        hole = 1 - (1 - curr_mask) * (1 - obj_mask_t)
        fill = inpainter((1 - curr_mask) * (1 - obj_mask_t) * img, hole)
        out_frames.append((1 - curr_mask) * img + curr_mask * fill)
    return torch.cat([real_vid[:, :ctx_len], torch.stack(out_frames, dim=1)], dim=1)
