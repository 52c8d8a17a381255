"""Per-net optimizer state and the step (counterpart of
waldo_tpu/train/train_state.py).

Adam or AdamW with the JAX package's names and defaults (``optimizer``,
``lr``, ``beta1``, ``beta2``, ``wd``: Adam, lr 1e-4, betas (0, 0.99)), the
update written out as optax computes it (eps 1e-8 outside the square root,
bias corrections from the step count). ``clip_value`` > 0 clips the
gradients by their global norm first. AdamW decays the leaves of more than
one dimension that are not biases and runs plain Adam on the others, the
rule the JAX package means to apply (its ``optax.masked`` lets the raw
gradient through as the update of the leaves outside the mask).

A non-finite loss skips the step: the gradients are zeroed, and parameters,
moments and step count keep their old values through ``torch.where`` on the
card, so no step waits for the host. ``nancount`` counts consecutive skipped
steps on the card; the trainer reads it now and then.

Under a process group (parallel/mesh.py) the step reduces the gradients
itself, in place of DDP, whose wrapper would reduce nothing here: the losses
call the nets by their methods, not their ``forward``. The gradients and the
rank's non-finite flag go into one flat buffer and one all-reduce a step;
every rank then applies the ranks' mean gradient, or skips when any rank's
loss was not finite. The parameters are broadcast from rank 0 once, at
construction, as DDP does. Without a process group the step is the same
path without the all-reduce.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from ..parallel import mesh


class NetState:
    """The optimizer state of one net: Adam's moments per parameter, the
    step count and the consecutive non-finite-loss count, on the net's
    device."""

    def __init__(self, module: torch.nn.Module, mcfg):
        if mcfg.optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {mcfg.optimizer!r}")
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        wd = mcfg.wd if mcfg.optimizer == "adamw" else 0.0
        self.decay = [wd if (p.dim() > 1 and not n.endswith("bias")) else 0.0
                      for n, p in named]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.nancount = torch.zeros((), dtype=torch.int32, device=dev)
        self.lr, self.b1, self.b2, self.eps = mcfg.lr, mcfg.beta1, mcfg.beta2, 1e-8
        self.clip = mcfg.clip_value
        mesh.broadcast_tensors_(self.params)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def gradients(self, loss: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The step's gradients, zero where it is skipped, and whether to take
        it (a 0-d bool on the card), from the parameters' ``.grad`` and
        ``loss``: under a process group the mean over the ranks, skipped on
        every rank if any rank's loss is not finite."""
        parts = [(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1).float()
                 for p in self.params]
        parts.append((~torch.isfinite(loss.detach())).float().reshape(1))
        flat = torch.cat(parts)
        if mesh.distributed():
            dist.all_reduce(flat)
        finite = flat[-1] == 0
        flat = torch.where(finite, flat[:-1] / mesh.world_size(), 0.0)
        grads = [v.view_as(p).to(p.dtype)
                 for p, v in zip(self.params, flat.split([p.numel() for p in self.params]))]
        return grads, finite

    @torch.no_grad()
    def apply(self, loss: torch.Tensor) -> None:
        """One optimizer step from the parameters' ``.grad``, skipped where
        ``loss`` (any rank's, under a process group) is not finite."""
        grads, finite = self.gradients(loss)
        if self.clip > 0:
            g_norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            keep = g_norm < self.clip
            grads = [torch.where(keep, g, (g / g_norm) * self.clip) for g in grads]
        count = self.count + 1
        c1 = 1 - self.b1 ** count.float()
        c2 = 1 - self.b2 ** count.float()
        for p, g, mu, nu, wd in zip(self.params, grads, self.mu, self.nu, self.decay):
            mu_new = (1 - self.b1) * g + self.b1 * mu
            nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
            upd = (mu_new / c1) / (torch.sqrt(nu_new / c2) + self.eps)
            if wd:
                upd = upd + wd * p
            p.copy_(torch.where(finite, p - self.lr * upd, p))
            mu.copy_(torch.where(finite, mu_new, mu))
            nu.copy_(torch.where(finite, nu_new, nu))
        self.count.copy_(torch.where(finite, count, self.count))
        self.nancount.copy_(torch.where(finite, torch.zeros_like(self.nancount),
                                        self.nancount + 1))
