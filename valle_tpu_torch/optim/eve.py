"""Eve: AdamW whose decoupled weight decay applies only while a tensor's
norm exceeds ``target_rms * sqrt(numel)``; one-element parameters are never
decayed. Mirror of ``valle_tpu/optim/eve.py`` (reference
``valle/modules/optim.py:836-985``)."""

from __future__ import annotations

import math

import torch


class Eve(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.98),
                 eps: float = 1e-8, weight_decay: float = 1e-3,
                 target_rms: float = 0.1):
        super().__init__(params, dict(lr=lr))
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.target_rms = target_rms
        self.step_count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["exp_avg"] = torch.zeros_like(p)
                self.state[p]["exp_avg_sq"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Eve takes no closure")
        self.step_count += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** self.step_count
        bc2 = 1 - b2 ** self.step_count
        for group in self.param_groups:
            for p in group["params"]:
                g = (p.grad if p.grad is not None
                     else torch.zeros_like(p)).float()
                st = self.state[p]
                st["exp_avg"] = st["exp_avg"] * b1 + g * (1 - b1)
                st["exp_avg_sq"] = st["exp_avg_sq"] * b2 + g * g * (1 - b2)
                denom = st["exp_avg_sq"].sqrt() * bc2 ** -0.5 + self.eps
                delta = -(group["lr"] / bc1) * st["exp_avg"] / denom
                if p.numel() > 1:
                    pf = p.float()
                    above = (pf.norm() > self.target_rms
                             * math.sqrt(p.numel())).float()
                    delta = delta + (-pf * (self.weight_decay * above))
                p.add_(delta.to(p.dtype))
