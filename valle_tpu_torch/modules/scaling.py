"""The gradient-shaping toolbox of the ``--scaling-xformers`` Transformer
(icefall's "scaled" training tricks).

Mirror of ``valle_tpu/modules/scaling.py``: DoubleSwish, ActivationBalancer,
BasicNorm / BalancedBasicNorm, ScaledLinear / ScaledConv1d, Whiten,
penalize_abs_values_gt, random_clamp, RandomGrad, the output-saving softmax,
MaxEig and the spectral-norm SRLinear / SRConv1d. Every JAX ``custom_vjp`` is
a ``torch.autograd.Function`` whose backward computes JAX's backward as
written: DoubleSwish's derivative is ``y (1 - s) + s`` in fp32 from the
saved output and sigmoid (JAX's form, not the reference's uint8 cache).

Randomness: PyTorch cannot replay JAX's draws, so every op that draws in
JAX takes its draw as an argument, in the form JAX compares it: a
balancer's ``gate`` (0 or 1: JAX's ``uniform < prob``), BasicNorm's
``clamp`` (JAX's ``uniform < 0.25``), MaxEig's uniform ``u`` (run iff
``u < cur_prob``), and the element-wise uniforms ``noise`` of
``random_clamp``, ``random_cast_to_half`` and ``random_grad``. No draw (None)
is JAX's "no rng": the op is the identity, or takes no clamp.
``draw_uniforms`` gives a caller its uniforms from a seed on the host.

Parameter names follow the reference: BasicNorm's learnable log-eps is
``eps`` (JAX ``log_eps``), BalancedBasicNorm holds it as ``norm.eps``;
ScaledLinear and ScaledConv1d are ``nn.Linear`` / ``nn.Conv1d`` with a
scaled init; SRLinear adds ``sigma`` and the power-iteration buffer ``u``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def draw_uniforms(seed: Optional[int], n: int):
    """``n`` uniforms in [0, 1) from ``seed`` on the host (a list), or
    None without a seed."""
    if seed is None:
        return None
    gen = torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))
    return torch.rand(n, generator=gen).tolist()


def balancer_prob(min_prob: float, step=None):
    """The balancer's application probability: ``min_prob``, or with a
    ``step`` the reference's decaying schedule max(min_prob,
    0.5^(1 + step / 4000)) in fp32."""
    if step is None:
        return min_prob
    s = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp_min(0.5 ** (1.0 + s / 4000.0), min_prob)


# ---------------------------------------------------------------------------
# DoubleSwish
# ---------------------------------------------------------------------------


class DoubleSwishFunction(torch.autograd.Function):
    """x * sigmoid(x - 1), computed in fp32; the backward reads the saved
    output y and sigmoid s: g * (y (1 - s) + s)."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        s = torch.sigmoid(xf - 1.0)
        y = xf * s
        ctx.save_for_backward(y, s)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        y, s = ctx.saved_tensors
        return (g.float() * (y * (1 - s) + s)).to(g.dtype)


def double_swish(x: torch.Tensor) -> torch.Tensor:
    return DoubleSwishFunction.apply(x)


# ---------------------------------------------------------------------------
# ActivationBalancer
# ---------------------------------------------------------------------------


def _other_dims(x, channel_dim: int):
    cd = channel_dim % x.ndim
    return cd, tuple(d for d in range(x.ndim) if d != cd)


def _compute_sign_factor(x, channel_dim, min_positive, max_positive,
                         gain_factor, max_factor):
    _, dims = _other_dims(x, channel_dim)
    prop_pos = (x > 0).float().mean(dim=dims)
    factor1 = (torch.clamp((min_positive - prop_pos)
                           * (gain_factor / min_positive), 0, max_factor)
               if min_positive != 0.0 else 0.0)
    factor2 = (torch.clamp((prop_pos - max_positive)
                           * (gain_factor / (1.0 - max_positive)), 0,
                           max_factor)
               if max_positive != 1.0 else 0.0)
    return factor1 - factor2


def _compute_scale_factor(x, channel_dim, min_abs, max_abs, gain_factor,
                          max_factor):
    _, dims = _other_dims(x, channel_dim)
    x_abs_mean = x.abs().mean(dim=dims).float()
    below = (torch.clamp((min_abs - x_abs_mean) * (gain_factor / min_abs),
                         0, max_factor) if min_abs != 0.0 else 0.0)
    above = torch.clamp((x_abs_mean - max_abs) * (gain_factor / max_abs),
                        0, max_factor)
    return below - above


class BalancerFunction(torch.autograd.Function):
    """Identity forward; the backward subtracts |g| * factor * gate, factor
    = scale_factor * ((x > 0) - 0.5) + sign_factor along ``channel_dim``
    (JAX ``_balancer_core``)."""

    @staticmethod
    def forward(ctx, x, scale_factor, sign_factor, gate, channel_dim):
        ctx.channel_dim = channel_dim
        ctx.has_sign = sign_factor is not None
        ctx.save_for_backward(x > 0, scale_factor, gate,
                              *([sign_factor] if ctx.has_sign else []))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        xgt0, scale_factor, gate, *sign = ctx.saved_tensors
        shape = [1] * g.ndim
        shape[ctx.channel_dim % g.ndim] = -1
        factor = scale_factor.reshape(shape) * (xgt0.to(g.dtype) - 0.5)
        if ctx.has_sign:
            factor = factor + sign[0].reshape(shape)
        neg_delta = g.abs() * factor * gate
        return (g - neg_delta).to(g.dtype), None, None, None, None


def activation_balancer(x, gate=None, *, channel_dim: int = -1,
                        min_positive: float = 0.05,
                        max_positive: float = 0.95, max_factor: float = 0.04,
                        sign_gain_factor: float = 0.01,
                        scale_gain_factor: float = 0.02,
                        min_abs: float = 0.2, max_abs: float = 100.0,
                        min_prob: float = 0.1, step=None,
                        training: bool = True):
    """The gradient balancer (reference scaling.py:639-764), applied when
    ``gate`` is 1: JAX draws it as ``uniform < balancer_prob(min_prob,
    step)``, and the gains are divided by that live probability. The
    identity in eval or without a gate."""
    if not training or gate is None:
        return x
    prob = balancer_prob(min_prob, step)
    xd = x.detach()
    if min_positive != 0.0 or max_positive != 1.0:
        sign_factor = _compute_sign_factor(
            xd, channel_dim, min_positive, max_positive,
            gain_factor=sign_gain_factor / prob, max_factor=max_factor)
    else:
        sign_factor = None
    scale_factor = _compute_scale_factor(
        xd, channel_dim, min_abs=min_abs, max_abs=max_abs,
        gain_factor=scale_gain_factor / prob, max_factor=max_factor)
    gate = torch.as_tensor(gate, dtype=torch.float32, device=x.device)
    return BalancerFunction.apply(x, scale_factor, sign_factor, gate,
                                  channel_dim)


def balanced_double_swish(x, gate=None, *, channel_dim: int = -1,
                          max_abs: float = 10.0, min_prob: float = 0.25,
                          step=None, training: bool = True):
    """ActivationBalancer -> DoubleSwish (reference scaling.py:1225-1236)."""
    x = activation_balancer(x, gate, channel_dim=channel_dim,
                            max_abs=max_abs, min_prob=min_prob, step=step,
                            training=training)
    return double_swish(x)


# ---------------------------------------------------------------------------
# BasicNorm / BalancedBasicNorm
# ---------------------------------------------------------------------------


class BasicNorm(nn.Module):
    """The learnable log-eps ``eps`` (a scalar; JAX ``log_eps``)."""

    def __init__(self, eps: float = 0.25):
        super().__init__()
        self.init_eps = eps
        self.eps = nn.Parameter(torch.tensor(math.log(eps)))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.eps.fill_(math.log(self.init_eps))


class BalancedBasicNorm(nn.Module):
    """ActivationBalancer(0.45, 0.55, max_abs 6) -> BasicNorm (reference
    transformer.py:133-157); its parameter is ``norm.eps``."""

    def __init__(self, eps: float = 0.25):
        super().__init__()
        self.norm = BasicNorm(eps)


def basic_norm(norm: BasicNorm, x, *, channel_dim: int = -1, clamp=None,
               training: bool = True, eps_min: float = -3.0,
               eps_max: float = 3.0):
    """x * (mean(x^2) + exp(log_eps))^-0.5 in fp32, returned in x's dtype.
    In training a true ``clamp`` (JAX: ``uniform < 0.25``) first clamps
    log-eps to [eps_min, eps_max]."""
    log_eps = norm.eps
    if training and clamp:
        log_eps = torch.clamp(log_eps, eps_min, eps_max)
    xf = x.float()
    scales = ((xf * xf).mean(dim=channel_dim, keepdim=True)
              + log_eps.float().exp()) ** -0.5
    return (xf * scales).to(x.dtype)


def balanced_basic_norm(bbn: BalancedBasicNorm, x, *, gate=None, clamp=None,
                        training: bool = True, step=None):
    x = activation_balancer(x, gate, channel_dim=-1, min_positive=0.45,
                            max_positive=0.55, max_abs=6.0, step=step,
                            training=training)
    return basic_norm(bbn.norm, x, clamp=clamp, training=training)


# ---------------------------------------------------------------------------
# Scaled initializers (reference scaling.py:427-470)
# ---------------------------------------------------------------------------


class ScaledLinear(nn.Linear):
    """``nn.Linear`` whose init is scaled by ``initial_scale``: weights
    U(+-sqrt(3 / fan_in)) x scale, bias U(+-0.1 x scale)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 initial_scale: float = 1.0):
        self.initial_scale = initial_scale
        super().__init__(d_in, d_out, bias=bias)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        init_scaled(self, gen, self.initial_scale)


class ScaledConv1d(nn.Conv1d):
    """``nn.Conv1d`` (weight (out, in, k)) with the scaled init: weights
    U(+-1 / sqrt(in x k)) x scale, bias U(+-0.1 x scale)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 bias: bool = True, initial_scale: float = 1.0):
        self.initial_scale = initial_scale
        super().__init__(c_in, c_out, kernel_size, bias=bias)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        init_scaled(self, gen, self.initial_scale)


def init_scaled(layer, gen: Optional[torch.Generator],
                initial_scale: float) -> None:
    """JAX ``init_scaled_linear`` / ``init_scaled_conv1d`` on ``layer``."""
    w = layer.weight
    if w.ndim == 2:
        bound = math.sqrt(3.0 / w.shape[1])
    else:
        bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2])
    w.uniform_(-bound, bound, generator=gen).mul_(initial_scale)
    if layer.bias is not None:
        layer.bias.uniform_(-0.1 * initial_scale, 0.1 * initial_scale,
                            generator=gen)


def _same_pad(x, kernel_size: int, stride: int):
    """XLA's SAME padding of x (B, C, T) for a 1-D conv."""
    T = x.shape[-1]
    out = -(-T // stride)
    total = max((out - 1) * stride + kernel_size - T, 0)
    return F.pad(x, (total // 2, total - total // 2))


def _conv1d_same(x, weight, bias, stride: int):
    """x (B, T, C_in), weight (out, in, k) -> (B, T', out), SAME."""
    xt = _same_pad(x.transpose(1, 2), weight.shape[-1], stride)
    y = F.conv1d(xt, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride)
    return y.transpose(1, 2)


def scaled_conv1d(conv: nn.Conv1d, x, *, stride: int = 1):
    """SAME-padded 1-D conv, x (B, T, C) -> (B, T', C_out)."""
    return _conv1d_same(x, conv.weight, conv.bias, stride)


# ---------------------------------------------------------------------------
# Whitening penalty (reference scaling.py:806-1000)
# ---------------------------------------------------------------------------


def whitening_metric(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """1.0 iff the grouped covariance eigenvalues are all equal."""
    x = x.reshape(-1, x.shape[-1]).float()
    num_frames, num_channels = x.shape
    assert num_channels % num_groups == 0
    cpg = num_channels // num_groups
    x = x.reshape(num_frames, num_groups, cpg).transpose(0, 1)
    x = x - x.mean(dim=1, keepdim=True)
    x_covar = x.transpose(1, 2) @ x
    x_covar_mean_diag = torch.diagonal(x_covar, dim1=1, dim2=2).mean()
    x_covarsq_mean_diag = (x_covar ** 2).sum() / (num_groups * cpg)
    return x_covarsq_mean_diag / (x_covar_mean_diag ** 2 + 1e-20)


class WhitenFunction(torch.autograd.Function):
    """Identity forward; the backward adds the gradient of
    relu(whitening_metric - limit), scaled to ``grad_scale`` x |g|."""

    @staticmethod
    def forward(ctx, x, num_groups, whitening_limit, grad_scale):
        ctx.args = (num_groups, whitening_limit, grad_scale)
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        num_groups, limit, grad_scale = ctx.args
        with torch.enable_grad():
            xd = x.detach().float().requires_grad_(True)
            penalty = F.relu(whitening_metric(xd, num_groups) - limit)
            (pg,) = torch.autograd.grad(penalty, xd)
        gf = g.float()
        scale = grad_scale * (torch.linalg.vector_norm(gf)
                              / (torch.linalg.vector_norm(pg) + 1e-20))
        return (gf + pg * scale).to(g.dtype), None, None, None


def whiten(x, num_groups: int, whitening_limit: float, grad_scale: float):
    return WhitenFunction.apply(x, num_groups, whitening_limit, grad_scale)


# ---------------------------------------------------------------------------
# Misc grad-shaping ops
# ---------------------------------------------------------------------------


class PenalizeAbsValuesGt(torch.autograd.Function):
    """Identity forward; the backward adds penalty x sign(x) where |x| >
    limit."""

    @staticmethod
    def forward(ctx, x, limit, penalty):
        ctx.penalty = penalty
        ctx.save_for_backward(torch.sign(x) * ((x.abs() - limit) > 0))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (signed_over,) = ctx.saved_tensors
        return g + ctx.penalty * signed_over.to(g.dtype), None, None


def penalize_abs_values_gt(x, limit: float = 10.0, penalty: float = 1e-4):
    return PenalizeAbsValuesGt.apply(x, limit, penalty)


def random_clamp(x, noise, min_val=None, max_val=None, prob: float = 0.5,
                 reflect: float = 0.0):
    """Per-element randomized clamp (reference scaling.py:212-219): where
    ``noise`` (uniforms of x's shape) < prob, x clamped to [min_val,
    max_val]; the straight-through backward comes from ``torch.where``."""
    clamped = torch.clamp(x, min_val, max_val)
    ans = torch.where(noise < prob, clamped, x)
    if reflect != 0.0:
        ans = ans * (1.0 + reflect) - x * reflect
    return ans


class SoftmaxFunction(torch.autograd.Function):
    """Softmax in fp32 whose backward reads only the saved output
    (reference SoftmaxFunction)."""

    @staticmethod
    def forward(ctx, x, dim):
        ans = torch.softmax(x.float(), dim=dim).to(x.dtype)
        ctx.dim = dim
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        ansf, gf = ans.float(), g.float()
        xg = ansf * gf
        xg = xg - ansf * xg.sum(dim=ctx.dim, keepdim=True)
        return xg.to(g.dtype), None


def softmax(x, dim: int = -1):
    return SoftmaxFunction.apply(x, dim)


# ---------------------------------------------------------------------------
# RandomGrad (reference scaling.py:222-280)
# ---------------------------------------------------------------------------


def random_cast_to_half(x, noise, *, min_abs: float = 5.0e-06,
                        dtype=torch.float16):
    """Expectation-preserving cast to a 16-bit float: entries below
    ``min_abs`` become +-min_abs where ``noise`` * min_abs < |x| (noise:
    uniforms of x's shape), else 0."""
    x_abs = x.abs()
    rand_val = (min_abs * torch.sign(x)
                * (noise * min_abs < x_abs).to(x.dtype))
    return torch.where(x_abs < min_abs, rand_val, x).to(dtype)


class RandomGradFunction(torch.autograd.Function):
    """Identity forward; a 16-bit gradient goes through
    ``random_cast_to_half`` with the saved ``noise``."""

    @staticmethod
    def forward(ctx, x, noise, min_abs):
        ctx.min_abs = min_abs
        ctx.save_for_backward(noise)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (noise,) = ctx.saved_tensors
        if g.dtype in (torch.float16, torch.bfloat16):
            g = random_cast_to_half(g.float(), noise, min_abs=ctx.min_abs,
                                    dtype=g.dtype)
        return g, None, None


def random_grad(x, noise=None, *, min_abs: float = 5.0e-06,
                training: bool = True):
    """Identity forward; in backward, tiny 16-bit gradients are removed
    with an expectation-preserving randomization (reference RandomGrad)
    drawn from ``noise`` (uniforms of x's shape)."""
    if not training or noise is None:
        return x
    return RandomGradFunction.apply(x, noise, float(min_abs))


# ---------------------------------------------------------------------------
# MaxEig (reference scaling.py:1002-1153)
# ---------------------------------------------------------------------------


def init_max_eig(num_channels: int, device=None) -> Dict[str, torch.Tensor]:
    """The power-iteration direction estimate and the application
    probability (the reference's ``max_eig_direction`` and ``cur_prob``)."""
    d = torch.arange(num_channels, dtype=torch.float32, device=device)
    return {"direction": d / torch.linalg.vector_norm(d),
            "cur_prob": torch.tensor(1.0, device=device)}


def _rows(x, channel_dim: int):
    """x as (frames, C) rows along ``channel_dim``, centred."""
    xm = torch.movedim(x, channel_dim % x.ndim, -1).reshape(-1, x.shape[
        channel_dim])
    return xm - xm.mean(dim=0)


class MaxEigFunction(torch.autograd.Function):
    """Identity forward; the backward adds, under ``gate``, the gradient of
    the top direction's variance proportion scaled to ``scale`` x |g|."""

    @staticmethod
    def forward(ctx, x, coeffs, direction, gate, channel_dim, scale):
        ctx.args = (channel_dim, scale)
        ctx.save_for_backward(x.detach(), coeffs, direction, gate)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x_orig, coeffs, direction, gate = ctx.saved_tensors
        channel_dim, scale = ctx.args
        with torch.enable_grad():
            xd = x_orig.float().requires_grad_(True)
            xm = _rows(xd, channel_dim)
            x_var = (xm ** 2).mean()
            resid_var = ((xm - coeffs * direction) ** 2).mean()
            vp = (x_var - resid_var) / (x_var + 1.0e-20)
            (pg,) = torch.autograd.grad(vp, xd)
        gf = g.float()
        extra = pg * (scale * torch.linalg.vector_norm(gf)
                      / (torch.linalg.vector_norm(pg) + 1.0e-20))
        return ((gf + gate * extra).to(g.dtype), None, None, None, None,
                None)


def max_eig(state, x, u=None, *, channel_dim: int = -1,
            max_var_per_eig: float = 0.2, min_prob: float = 0.01,
            scale: float = 0.01, training: bool = True):
    """Discourage one direction from dominating the activations' covariance
    (reference MaxEig). ``u`` is JAX's uniform: the step runs iff u <
    ``state["cur_prob"]``. Returns (x, new_state): the direction moves one
    power-iteration step when the step runs; the gradient edit applies
    when it runs and the top direction's variance proportion is >=
    ``max_var_per_eig``; cur_prob snaps to 1 then, else regresses towards
    ``min_prob``."""
    if not training or u is None or max_var_per_eig <= 0:
        return x, state
    with torch.no_grad():
        xm = _rows(x.detach().float(), channel_dim)
        prev = state["direction"]
        coeffs = (xm * prev).sum(dim=1, keepdim=True) + 1.0e-10
        new_dir = (xm * coeffs).sum(dim=0) / ((coeffs ** 2).sum() + 1.0e-20)
        x_var = (xm ** 2).mean()
        resid_var = ((xm - coeffs * new_dir) ** 2).mean()
        vp = (x_var - resid_var) / (x_var + 1.0e-20)
        run = torch.as_tensor(u, device=prev.device) < state["cur_prob"]
        active = run & (vp >= max_var_per_eig)
        nd = 0.1 * prev + new_dir
        nd = nd / (torch.linalg.vector_norm(nd) + 1.0e-20)
        nd = torch.where(torch.isfinite(nd).all(), nd, prev)
        cur = state["cur_prob"]
        new_state = {
            "direction": torch.where(run, nd, prev),
            "cur_prob": torch.where(
                run, torch.where(active, torch.ones_like(cur),
                                 0.75 * cur + 0.25 * min_prob), cur)}
    y = MaxEigFunction.apply(x, coeffs, new_dir, active.float(),
                             channel_dim, scale)
    return y, new_state


# ---------------------------------------------------------------------------
# SRLinear / SRConv1d (spectral norm, reference scaling.py:551-615)
# ---------------------------------------------------------------------------


class SRLinear(nn.Linear):
    """``nn.Linear`` scaled to ``sigma`` / ||W||_2, ||W||_2 estimated by one
    power-iteration step a call from the buffer ``u`` (the input
    dimension)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__(d_in, d_out, bias=bias)
        self.sigma = nn.Parameter(torch.ones(1))
        self.register_buffer("u", F.normalize(torch.ones(d_in), dim=0))

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        """JAX ``init_sr_linear``: torch-Linear bounds, sigma 1, u a
        normalized Gaussian."""
        fan_in = self.weight.shape[1]
        bound = math.sqrt(3.0 / fan_in)
        if isinstance(self, SRConv1d):
            bound = 1.0 / math.sqrt(fan_in)
        self.weight.uniform_(-bound, bound, generator=gen)
        if self.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            self.bias.uniform_(-b, b, generator=gen)
        if hasattr(self, "sigma"):
            self.sigma.fill_(1.0)
            self.u.normal_(generator=gen)
            self.u.div_(torch.linalg.vector_norm(self.u))


def _spectral_weight(layer: SRLinear, training: bool):
    """(sigma / sigma_est) x W, with u moved one step in place in
    training."""
    with torch.no_grad():
        w = layer.weight.float()
        v = w @ layer.u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = w.T @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
        sigma_est = v @ (w @ u_new)
        if training:
            layer.u.copy_(u_new)
    return (layer.sigma / (sigma_est + 1e-12)) * layer.weight.float()


def sr_linear(layer: SRLinear, x, *, training: bool = True):
    weight = _spectral_weight(layer, training)
    y = x @ weight.to(x.dtype).T
    return y + layer.bias.to(x.dtype) if layer.bias is not None else y


class SRConv1d(SRLinear):
    """The spectral-norm conv: the (out, in x k) flattened weight is
    normalized as SRLinear's (the reference subclasses SRLinear with
    in_features = in x k)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 bias: bool = True):
        self.kernel_size = kernel_size
        super().__init__(c_in * kernel_size, c_out, bias=bias)


def sr_conv1d(layer: SRConv1d, x, *, stride: int = 1,
              training: bool = True):
    """SAME-padded spectral-norm conv, x (B, T, C_in) -> (B, T', C_out)."""
    weight = _spectral_weight(layer, training)
    c_out, k = weight.shape[0], layer.kernel_size
    return _conv1d_same(x, weight.reshape(c_out, -1, k), layer.bias, stride)
