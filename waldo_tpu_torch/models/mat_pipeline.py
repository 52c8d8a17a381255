"""MAT inpainting post-processing of the predicted video (counterpart of
waldo_tpu/models/mat_pipeline.py, the test_mat path).

Builds disocclusion masks from the warped per-layer alphas, inpaints the
reference (last) frame once with background propagated from the context
frames along the background flow, optionally finds soft shadows and
completes objects entering from the left or right border (polygon masks,
decided on the host), then warps the inpainted reference to every predicted
frame and inpaints what is left. B=1 inference; the per-frame loops are
Python loops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import grid_sample
from ..utils.profiling import annotate
from .mat.inpainter import expand_mask


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
    """Ray-casting point-in-polygon. pts (B, H, W, 2) pixel coordinates;
    corners a list of (x, y). Returns (B, H, W, 1) in pts' dtype."""
    x, y = pts[..., 0], pts[..., 1]
    inside = torch.zeros(x.shape, dtype=torch.bool, device=pts.device)
    n = len(corners)
    for i in range(n):
        x1, y1 = corners[i]
        x2, y2 = corners[(i + 1) % n]
        cond = ((y1 > y) != (y2 > y)) & (x < (x2 - x1) * (y - y1) / (y2 - y1 + 1e-12) + x1)
        inside = inside ^ cond
    return inside[..., None].to(pts.dtype)


def _warp(img, flow, src_grid):
    return grid_sample(img, flow + src_grid[None])


@torch.inference_mode()
def inpaint_with_mat(cfg, warper, wif_apply, inpainter, raw_output, alpha,
                     alpha_ctx, real_vid, pred_flow, ctx_len, grids):
    """The full post-processing chain. All videos channel-last.

    raw_output (B,Tc',Tp,Hd,Wd,C'), alpha (B,Tp,Hd,Wd,No+1),
    alpha_ctx (B,Tc,Tp,Hd,Wd,No+1), real_vid (B,T,Hd,Wd,3),
    pred_flow (B,Tc,Tp,Hd,Wd,2); ``wif_apply`` maps a raw stack to fused
    frames (the synthesizer's ``wif``). Returns inp_pred_vid (B,T,Hd,Wd,3)."""
    m = cfg.model
    src_grid = warper.src_grid_hd
    hd, wd = src_grid.shape[:2]
    b, _, tp = raw_output.shape[:3]
    mask_thresh = 0.1
    shadow_mask = None

    a01 = (alpha_ctx + 1) / 2  # B Tc Tp Hd Wd L

    if m.use_inpainter:
        cov = a01.sum(-1)  # B Tc Tp Hd Wd
        mask = 1 - (cov[:, -1] if m.ii_last_only else cov.amax(dim=1))
        mask = mask[..., None]
        mask = ((mask > mask_thresh) if m.fix_thresh else (mask > 1 - mask_thresh)).float()
        obj_cov = a01[..., 1:].sum(-1)
        obj_mask = (obj_cov[:, -1] if m.ii_last_only else obj_cov.amax(dim=1))[..., None]
        obj_mask = (obj_mask > 0.9).float()
        if m.use_expansion:
            mask = expand_mask(mask, num=m.num_expansion)
            mask = mask * (1 - obj_mask)

    if not m.loop_ii:
        with annotate("mat/fuse"):
            inp = wif_apply(raw_output)
        if m.use_inpainter:
            frames = []
            for t in range(tp):
                if m.inpaint_obj:
                    hole = 1 - (1 - mask[:, t]) * (1 - obj_mask[:, t])
                    masked = (1 - hole) * inp[:, t]
                    fill = inpainter(masked, hole)
                    frames.append((1 - mask[:, t]) * inp[:, t] + mask[:, t] * fill)
                else:
                    masked = (1 - mask[:, t]) * inp[:, t]
                    frames.append(inpainter(masked, mask[:, t]))
            inp = torch.stack(frames, dim=1)
        return torch.cat([real_vid[:, :ctx_len], inp], dim=1)

    # loop_ii path: per-frame fusion + reference-frame propagation
    with annotate("mat/fuse"):
        inp_frames = [wif_apply(raw_output[:, :, t: t + 1])[:, 0] for t in range(tp)]
    if not m.use_inpainter:
        return torch.cat([real_vid[:, :ctx_len], torch.stack(inp_frames, dim=1)], dim=1)

    if not (m.inpaint_obj and m.propagate_unique):
        raise ValueError("the loop_ii inpainting path needs inpaint_obj and propagate_unique")
    ref = -1
    with annotate("mat/flows"):
        ref_to_pred_bg = warper.grid_to_bg_flow_from_ref_to_pred(grids, ctx_len, ref)
        ctx_to_ref_bg = warper.grid_to_bg_flow_from_ctx_to_ref(grids, ctx_len, ref)
    ref_img = inp_frames[ref]
    obj_mask_ref = obj_mask[:, ref]
    ref_left = ref_right = None

    # gather background from the context frames
    with annotate("mat/gather_context"):
        for t2 in range(ctx_len - 1, -1, -1):
            ctx_img = real_vid[:, t2]
            ctx_mask = (alpha[..., :1][:, t2] > 1 - mask_thresh).float()
            warped_img = _warp(ctx_img, ctx_to_ref_bg[:, t2], src_grid)
            warped_mask = _warp(ctx_mask, ctx_to_ref_bg[:, t2], src_grid)
            warped_mask = (warped_mask > 1 - mask_thresh).float()
            if m.use_shadows and t2 == ctx_len - 1:
                sm = ((warped_img - ref_img).abs().mean(-1, keepdim=True) > 0.25)
                sm = sm.float() * warped_mask * (1 - obj_mask_ref)
                sm = 1 - expand_mask(1 - sm, num=5)
                sm = expand_mask(sm, num=5)
                sm[:, : int(sm.shape[1] * 0.4)] = 0.0
                shadow_mask = soft_expand(sm, num=30) if m.soft_shadow else expand_mask(sm, num=30)
            inter = obj_mask_ref * warped_mask
            ref_img = inter * warped_img + (1 - inter) * ref_img
            obj_mask_ref = (1 - inter) * obj_mask_ref
            if m.ii_last_only:
                break

    # inpaint the reference frame
    ref_mask = 1 - (1 - mask[:, ref]) * (1 - obj_mask_ref)
    if m.fix_mask:
        ref_img = inpainter(ref_img, ref_mask, is_masked=False)
    else:
        masked_ref = (1 - mask[:, ref]) * (1 - obj_mask_ref) * ref_img
        ref_img = inpainter(masked_ref, ref_mask)

    # off-screen object completion; the decisions are made on the host
    if m.propagate_obj:
        with annotate("mat/propagate_obj"):
            border = 3
            pred_grid = (pred_flow[:, -1, -1] + src_grid[None]).float().cpu().numpy().copy()
            pred_grid[..., 0] = (pred_grid[..., 0] * wd + wd - 1) / 2
            pred_grid[..., 1] = (pred_grid[..., 1] * hd + hd - 1) / 2
            orig = src_grid.float().cpu().numpy().copy()[None]
            orig[..., 0] = (orig[..., 0] * wd + wd - 1) / 2
            orig[..., 1] = (orig[..., 1] * hd + hd - 1) / 2
            is_left = pred_grid[..., 0] < border
            is_right = pred_grid[..., 0] >= wd - border
            all_obj = (((alpha_ctx[:, :, -1, :, :, 1:] + 1) / 2).amax(dim=1) > 0.9).cpu().numpy()
            is_left_obj = is_left[..., None] & all_obj
            is_right_obj = is_right[..., None] & all_obj
            orig_t = torch.as_tensor(orig, device=src_grid.device)

            def complete(side_obj, side):
                oid = int(side_obj.reshape(b, -1, side_obj.shape[-1]).sum(1).argmax(1)[0])
                sel = side_obj[..., oid]
                bv = pred_grid[sel]
                ovs = orig[0][sel[0]]
                if side == "left":
                    corners = [(0, float(bv[:, 1].min())), (0, float(bv[:, 1].max())),
                               (float(ovs[:, 0].max()), float(ovs[:, 1].max())),
                               (float(ovs[:, 0].max()), float(ovs[:, 1].min()))]
                else:
                    corners = [(float(ovs[:, 0].min()), float(ovs[:, 1].min())),
                               (float(ovs[:, 0].min()), float(ovs[:, 1].max())),
                               (wd - 1, float(bv[:, 1].max())), (wd - 1, float(bv[:, 1].min()))]
                pmask = point_in_polygon(orig_t, corners)
                masked = (1 - pmask) * raw_output[:, -1, -1, :, :, :3]
                obj_fill = inpainter(masked, pmask)
                flow = warper.grid_to_obj_flow_from_ref_to_pred(grids, ctx_len, ref, oid)
                return pmask, obj_fill, flow

            if is_left_obj.sum() > 0:
                ref_left = complete(is_left_obj, "left")
            if is_right_obj.sum() > 0:
                ref_right = complete(is_right_obj, "right")

    # per-frame forward warp of the inpainted reference
    out_frames = []
    for t in range(tp):
        with annotate("mat/propagate_frame"):
            img = inp_frames[t]
            curr_mask = mask[:, t]
            warped_img = _warp(ref_img, ref_to_pred_bg[:, t], src_grid)
            warped_mask = _warp(ref_mask, ref_to_pred_bg[:, t], src_grid)
            warped_mask = (warped_mask > 1 - mask_thresh).float()
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
        if m.fix_mask:
            hole = expand_mask(1 - (1 - curr_mask) * (1 - obj_mask_t), 3)
            fill = inpainter(img, hole, exp=False, is_masked=False)
        else:
            hole = 1 - (1 - curr_mask) * (1 - obj_mask_t)
            masked = (1 - curr_mask) * (1 - obj_mask_t) * img
            fill = inpainter(masked, hole)
        out_frames.append((1 - curr_mask) * img + curr_mask * fill)

    inp = torch.stack(out_frames, dim=1)
    return torch.cat([real_vid[:, :ctx_len], inp], dim=1)
