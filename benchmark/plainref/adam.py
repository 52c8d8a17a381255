"""Adam as the port's NetState writes it out (optax's update: eps 1e-8
outside the square root, bias corrections from the step count, clipping by
the global norm when ``clip_value`` > 0), on one process."""
from __future__ import annotations

from typing import List

import torch


class Adam:
    def __init__(self, params: List[torch.Tensor], mcfg):
        if mcfg.optimizer != "adam":
            raise ValueError(f"the reference steps Adam, not {mcfg.optimizer!r}")
        self.params = params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.lr, self.b1, self.b2, self.eps = mcfg.lr, mcfg.beta1, mcfg.beta2, 1e-8
        self.clip = mcfg.clip_value

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One step from these gradients (the loss is finite)."""
        if self.clip > 0:
            g_norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            if float(g_norm) >= self.clip:
                grads = [(g / g_norm) * self.clip for g in grads]
        self.count += 1
        # the bias corrections in float32 on the device, as the port takes them
        count = torch.tensor(float(self.count), device=self.params[0].device)
        c1 = 1 - self.b1 ** count
        c2 = 1 - self.b2 ** count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            p.copy_(p - self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.eps)))
