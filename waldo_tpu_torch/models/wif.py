"""WIF, the warping / inpainting / fusion network (counterpart of
waldo_tpu/models/wif.py, the UNet fusion path).

Input raw_output (B, Tc', Tp, Hd, Wd, C') with C' = 3 + num_lyt + num_obj+1
(+1 disocc when use_disocc); output the fused video (B, Tp, Hd, Wd, 3). The
gate comes from the UNet's 5th output channel (``ii_ref_gate`` replays the
reference's input-channel gate).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import UNet


class WIFNet(nn.Module):
    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        c_raw = 3 + cfg.data.num_lyt + m.num_obj + 1 + (1 if m.use_disocc else 0)
        if m.ii_score:
            in_ch, self.n_out = c_raw, (5 if m.ii_ab else 4)
            zero_init = m.ii_ab
        else:
            tc = m.ctx_len + (1 if m.include_self else 0)
            in_ch, self.n_out, zero_init = tc * c_raw, 3, False
        self.unet = UNet(in_ch, self.n_out, m.ii_embed_dim, m.norm_layer_patch, m.ii_depth,
                         zero_init=zero_init, dtype=dtype)

    def forward(self, vid):
        m = self.cfg.model
        b, tc, tp, h, w, c = vid.shape
        vid = vid.movedim(1, 2)  # B Tp Tc H W C
        if m.ii_score:
            x = vid.reshape(b * tp * tc, h, w, c)
        else:
            x = vid.movedim(2, -2).reshape(b * tp, h, w, tc * c)
        out = self.unet(x)
        if not m.ii_score:
            return out.reshape(b, tp, h, w, 3)
        out = out.reshape(b, tp, tc, h, w, self.n_out)
        beta = out[..., :3]
        score = out[..., 3:4].softmax(dim=2)
        if m.ii_ab:
            gate = vid[..., 4:5] if m.ii_ref_gate else out[..., 4:5]
            alpha = torch.sigmoid(gate + 5.0)
        else:
            alpha = 0.0
        return ((alpha * vid[..., :3] + beta) * score).sum(dim=2)
