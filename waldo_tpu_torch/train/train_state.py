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
"""
from __future__ import annotations

import torch


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

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def apply(self, loss: torch.Tensor) -> None:
        """One optimizer step from the parameters' ``.grad``, skipped where
        ``loss`` is not finite."""
        finite = torch.isfinite(loss.detach())
        grads = [torch.zeros_like(p) if p.grad is None else
                 torch.where(finite, p.grad, torch.zeros_like(p.grad)) for p in self.params]
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
