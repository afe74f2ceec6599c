"""ScaledAdam as a ``torch.optim.Optimizer``.

Mirror of ``valle_tpu/optim/scaled_adam.py`` (icefall's ScaledAdam, the
upstream reference's ``valle/modules/optim.py:129-661``): updates
proportional to each tensor's RMS, a learned per-tensor scale with its own
Adam-like moments, median-window gradient clipping, and plain Adam for
one-element parameters. The reference's quirks are kept: the clipped
gradient reaches only the size (scale) update, the main moments read the
raw gradient (``clip_main_grad=True`` clips both), and the clipping
threshold is ``clipping_scale`` times sorted window entry
``(period // 4) * 2``.

The JAX package keeps per-layer weights stacked on a leading axis with
per-slice statistics; the port keeps one tensor per layer, so its
statistics are per tensor, which is the same thing. ``state_dtype`` is the
storage type of the two parameter-sized buffers (``delta``, the momentum
that is also the applied update, and ``exp_avg_sq``); all arithmetic is
fp32. A parameter without a gradient is stepped with a zero gradient, as
the JAX update sees the zeros of an unused leaf.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class ScaledAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 3e-2,
                 clipping_scale: Optional[float] = None,
                 betas=(0.9, 0.98), scalar_lr_scale: float = 0.1,
                 eps: float = 1e-8, param_min_rms: float = 1e-5,
                 param_max_rms: float = 3.0, scalar_max: float = 10.0,
                 size_update_period: int = 4,
                 clipping_update_period: int = 100,
                 clip_main_grad: bool = False,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(lr=lr))
        self.clipping_scale = clipping_scale
        self.b1, self.b2 = betas
        self.scalar_lr_scale = scalar_lr_scale
        self.eps = eps
        self.param_min_rms = param_min_rms
        self.param_max_rms = param_max_rms
        self.scalar_max = scalar_max
        self.size_update_period = size_update_period
        self.clipping_update_period = clipping_update_period
        self.clip_main_grad = clip_main_grad
        self.state_dtype = state_dtype
        params = self._params()
        dev = params[0].device
        self.step_count = 0
        self.model_norms = torch.zeros(clipping_update_period, device=dev)
        self.model_norm_threshold = torch.tensor(math.inf, device=dev)
        self.num_clipped = torch.zeros((), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for p in params:
                self._init_state(p)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _init_state(self, p: torch.Tensor) -> None:
        st = self.state[p]
        st["delta"] = torch.zeros_like(p, dtype=self.state_dtype)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
        if p.numel() == 1:
            return
        pf = p.float()
        keep = (1,) * p.ndim
        st["param_rms"] = pf.pow(2).mean().sqrt().reshape(keep)
        st["scale_exp_avg_sq"] = torch.zeros(keep, device=p.device)
        st["scale_grads"] = torch.zeros((self.size_update_period,) + keep,
                                        device=p.device)

    @torch.no_grad()
    def _clip_factor(self, params, grads):
        """Median-window clipping (reference optim.py:316-412): the RMS-
        weighted grad norm enters a ring buffer; every period the
        threshold becomes clipping_scale x the quartile entry; once a full
        window is seen, clip = min(1, threshold / norm)."""
        sq = [g.float().pow(2).sum() if p.numel() == 1
              else (g.float() * self.state[p]["param_rms"]).pow(2).sum()
              for p, g in zip(params, grads)]
        tot_norm = torch.stack(sq).sum().sqrt()
        period, step = self.clipping_update_period, self.step_count
        self.model_norms[step % period] = tot_norm
        if step % period == 0 and step > 0:
            median = self.model_norms.sort().values[
                min(period - 1, (period // 4) * 2)]
            self.model_norm_threshold = self.clipping_scale * median
        if step < period:
            return 1.0
        clip = (self.model_norm_threshold / (tot_norm + 1e-20)).clamp(max=1.0)
        self.num_clipped += (clip < 1.0).long()
        return clip

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScaledAdam takes no closure")
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        clip = (self._clip_factor(params, grads)
                if self.clipping_scale is not None else 1.0)
        b1, b2, eps = self.b1, self.b2, self.eps
        sup = self.size_update_period
        step = self.step_count
        beta2_corr = b2 ** sup
        is_size_step = step % sup == sup - 1
        bc2_size = 1.0 - beta2_corr ** ((step + 1) // sup)
        bc2_main = 1.0 - b2 ** (step + 1)
        for group in self.param_groups:
            lr = group["lr"]
            size_lr = lr * self.scalar_lr_scale
            for p in group["params"]:
                g_raw = (p.grad if p.grad is not None
                         else torch.zeros_like(p)).float()
                g_clip = g_raw * clip
                g = g_clip if self.clip_main_grad else g_raw
                st = self.state[p]
                pf = p.float()
                delta = st["delta"].float() * b1
                eas = st["exp_avg_sq"].float() * b2 + g * g * (1 - b2)
                if p.numel() == 1:
                    # plain Adam for scalars (reference optim.py:639-661)
                    denom = (eas / bc2_main).sqrt() + eps
                    delta = delta + g / denom * (-size_lr * (1 - b1))
                    delta_st = delta.to(self.state_dtype)
                    p.add_((pf.clamp(-self.scalar_max, self.scalar_max) - pf
                            + delta_st.float()).to(p.dtype))
                else:
                    delta = self._size_update(st, pf, g_clip, delta,
                                              is_size_step, step, size_lr,
                                              beta2_corr, bc2_size)
                    eas_eff = eas / bc2_main if bc2_main < 0.99 else eas
                    alpha = (-lr * (1 - b1)
                             * st["param_rms"].clamp_min(self.param_min_rms))
                    delta = delta + (g / (eas_eff.sqrt() + eps)) * alpha
                    delta_st = delta.to(self.state_dtype)
                    # the applied update is the stored delta
                    p.add_(delta_st.float().to(p.dtype))
                st["delta"] = delta_st
                st["exp_avg_sq"] = eas.to(self.state_dtype)
        self.step_count += 1

    def _size_update(self, st, pf, g_clip, delta, is_size_step, step,
                     size_lr, beta2_corr, bc2_size):
        """Record this step's scale gradient; on a size step refresh the
        param RMS and the scale moments and add the scale step
        (reference optim.py:495-507, 555-596)."""
        sgrads = st["scale_grads"]
        sgrads[step % self.size_update_period] = (pf * g_clip).sum()
        if not is_size_step:
            return delta
        st["param_rms"] = pf.pow(2).mean().sqrt().reshape(
            st["param_rms"].shape)
        st["scale_exp_avg_sq"] = (st["scale_exp_avg_sq"] * beta2_corr
                                  + sgrads.pow(2).mean(0) * (1 - beta2_corr))
        if step == 0:
            return delta
        rms = st["param_rms"]
        scale_step = (-size_lr * math.sqrt(bc2_size) * sgrads.sum(0)
                      / (st["scale_exp_avg_sq"].sqrt() + self.eps))
        scale_step = torch.where(rms < self.param_min_rms,
                                 torch.zeros_like(scale_step), scale_step)
        scale_step = torch.where(
            rms > self.param_max_rms,
            torch.full_like(scale_step, -size_lr * self.size_update_period),
            scale_step)
        return delta + (1 - self.b1) * pf * scale_step
