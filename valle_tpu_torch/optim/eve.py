"""Eve: AdamW whose decoupled weight decay applies only while a tensor's
norm exceeds ``target_rms * sqrt(numel)``; one-element parameters are never
decayed. Mirror of ``valle_tpu/optim/eve.py`` (reference
``valle/modules/optim.py:836-985``)."""

from __future__ import annotations

import math

import torch


class Eve(torch.optim.Optimizer):
    """``sharded`` / ``model_shard`` as ``ScaledAdam``'s: the decay test
    takes the norm of the whole tensor of a split parameter."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.98),
                 eps: float = 1e-8, weight_decay: float = 1e-3,
                 target_rms: float = 0.1, sharded=None, model_shard=None):
        super().__init__(params, dict(lr=lr))
        n = sum(len(g["params"]) for g in self.param_groups)
        self.sharded = list(sharded) if sharded is not None else [False] * n
        self.model_shard = model_shard
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.target_rms = target_rms
        self.step_count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["exp_avg"] = torch.zeros_like(p)
                self.state[p]["exp_avg_sq"] = torch.zeros_like(p)

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["eve_step_count"] = self.step_count
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.step_count = int(state_dict.pop("eve_step_count"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Eve takes no closure")
        self.step_count += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** self.step_count
        bc2 = 1 - b2 ** self.step_count
        params = [p for g in self.param_groups for p in g["params"]]
        tp = self.model_shard.tp if self.model_shard is not None else 1
        norms = {}
        if tp > 1:
            from ..parallel.tensor import model_sums

            sums = model_sums([p.float().pow(2).sum() for p in params],
                              self.sharded, self.model_shard)
            norms = {id(p): (s.sqrt(), p.numel() * (tp if sh else 1))
                     for p, s, sh in zip(params, sums, self.sharded)}
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
                    norm, numel = norms.get(id(p), (None, p.numel()))
                    norm = pf.norm() if norm is None else norm
                    above = (norm > self.target_rms
                             * math.sqrt(numel)).float()
                    delta = delta + (-pf * (self.weight_decay * above))
                p.add_(delta.to(p.dtype))
