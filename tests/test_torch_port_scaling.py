"""The port's scaling toolbox (``valle_tpu_torch/modules/scaling.py``)
against ``valle_tpu/modules/scaling.py`` on the CPU: each op's forward and
backward (a seeded cotangent) on seeded numpy inputs, with every JAX draw
(a balancer's gate, BasicNorm's clamp, MaxEig's run, the element-wise
uniforms) computed from JAX's key in the test, the way JAX draws it, and
handed to the port. Forwards to 1e-6, gradients and state updates to
1e-5, relative to the largest entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.modules import scaling as jsc
from valle_tpu_torch.modules import scaling as sc

FWD, BWD = 1e-6, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed=0, shape=(3, 10, 16), scale=1.0, offset=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + offset).astype(np.float32)


def close(got, want, limit, what=""):
    got = got.detach().float().numpy() if hasattr(got, "detach") else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= limit, (what, err)


def check_op(jfn, tfn, x, limit_f=FWD, limit_b=BWD, seed=1):
    """Forward and the vjp of a seeded cotangent, JAX against the port."""
    cot = _x(seed, x.shape)

    @jax.jit
    def fwd_bwd(v, c):
        y, vjp = jax.vjp(jfn, v)
        return y, vjp(c)[0]

    jy, jg = fwd_bwd(jnp.asarray(x), jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    ty = tfn(tx)
    ty.backward(torch.tensor(cot))
    close(ty, jy, limit_f, "forward")
    close(tx.grad, jg, limit_b, "backward")


def test_double_swish():
    check_op(jsc.double_swish, sc.double_swish, _x(0, scale=3.0))


def _gate_key(prob, want: bool, start=0):
    """A JAX key whose balancer draw (uniform < prob) is ``want``."""
    for i in range(start, start + 200):
        k = jax.random.PRNGKey(i)
        if bool(jax.random.uniform(k, ()) < prob) == want:
            return k
    raise AssertionError("no key")


@pytest.mark.parametrize("gate", [0, 1])
@pytest.mark.parametrize("step", [None, 1000])
def test_activation_balancer(gate, step):
    """Both sign and scale factors active (a shifted, wide input), the
    gains divided by the live probability of the step schedule."""
    x = _x(2, offset=0.4, scale=3.0)
    prob = float(sc.balancer_prob(0.1, step))
    key = _gate_key(prob, bool(gate))
    jstep = None if step is None else jnp.asarray(step)
    kw = dict(channel_dim=-1, max_abs=2.0)
    check_op(lambda v: jsc.activation_balancer(v, key, step=jstep, **kw),
             lambda v: sc.activation_balancer(v, gate, step=step, **kw), x)
    if gate == 0:   # the identity in both directions
        tx = torch.tensor(x, requires_grad=True)
        sc.activation_balancer(tx, 0, **kw).sum().backward()
        assert torch.equal(tx.grad, torch.ones_like(tx))


def test_balanced_double_swish():
    x = _x(3, scale=4.0)
    key = _gate_key(0.25, True)
    check_op(lambda v: jsc.balanced_double_swish(v, key),
             lambda v: sc.balanced_double_swish(v, 1.0), x)


@pytest.mark.parametrize("log_eps", [np.log(0.25), 3.5])
def test_basic_norm_and_balanced(log_eps):
    """BasicNorm with and without its clamp (log-eps 3.5 is clamped to
    3), the gradient w.r.t. log-eps too; BalancedBasicNorm with JAX's two
    draws from the split key."""
    x = _x(4, scale=2.0)
    cot = _x(5, x.shape)
    for clamp in (False, True):
        key = _gate_key(0.25, clamp)

        def jf(v, le):
            return jsc.basic_norm({"log_eps": le}, v, rng=key)

        jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.float32(log_eps))
        jgx, jgl = vjp(jnp.asarray(cot))
        norm = sc.BasicNorm()
        with torch.no_grad():
            norm.eps.fill_(float(np.float32(log_eps)))
        tx = torch.tensor(x, requires_grad=True)
        ty = sc.basic_norm(norm, tx, clamp=clamp)
        ty.backward(torch.tensor(cot))
        close(ty, jy, FWD, ("basic_norm", clamp))
        close(tx.grad, jgx, BWD)
        assert norm.eps.grad.item() == pytest.approx(float(jgl), rel=BWD,
                                                     abs=1e-9)

        r1, r2 = jax.random.split(key)
        gate = float(jax.random.uniform(r1, ()) < 0.1)
        clamp = bool(jax.random.uniform(r2, ()) < 0.25)
        bbn = sc.BalancedBasicNorm()
        with torch.no_grad():
            bbn.norm.eps.fill_(float(np.float32(log_eps)))
        check_op(lambda v: jsc.balanced_basic_norm(
            {"norm": {"log_eps": jnp.float32(log_eps)}}, v, rng=key),
            lambda v: sc.balanced_basic_norm(bbn, v, gate=gate,
                                             clamp=clamp), x)


def test_whiten_and_metric():
    x = _x(6, shape=(40, 8))
    x[:, 1] += 3 * x[:, 0]          # correlated channels: penalty active
    close(sc.whitening_metric(torch.tensor(x), 2),
          jsc.whitening_metric(jnp.asarray(x), 2), FWD)
    check_op(lambda v: jsc.whiten(v, 2, 1.0, 0.1),
             lambda v: sc.whiten(v, 2, 1.0, 0.1), x)


def test_penalize_abs_values_gt():
    check_op(lambda v: jsc.penalize_abs_values_gt(v, 1.5, 1e-2),
             lambda v: sc.penalize_abs_values_gt(v, 1.5, 1e-2),
             _x(7, scale=2.0))


def test_softmax():
    check_op(lambda v: jsc.softmax(v, -1), lambda v: sc.softmax(v, -1),
             _x(8, scale=3.0))


def test_random_clamp_and_cast():
    x = _x(9, scale=2.0)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(key, x.shape))
    check_op(lambda v: jsc.random_clamp(v, key, -1.0, 1.0, prob=0.5,
                                        reflect=0.1),
             lambda v: sc.random_clamp(v, torch.tensor(noise), -1.0, 1.0,
                                       prob=0.5, reflect=0.1), x)
    tiny = _x(10, scale=1e-5)
    want = jsc.random_cast_to_half(jnp.asarray(tiny), key, min_abs=5e-6)
    got = sc.random_cast_to_half(torch.tensor(tiny), torch.tensor(noise),
                                 min_abs=5e-6)
    assert got.dtype == torch.float16
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_random_grad():
    """A bf16 gradient with entries below min_abs goes through the
    randomized cast with JAX's uniforms; an fp32 one passes untouched."""
    key = jax.random.PRNGKey(11)
    x = _x(11, shape=(6, 32))
    cot = _x(12, x.shape, scale=1e-5)
    noise = torch.tensor(np.asarray(jax.random.uniform(key, x.shape)))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        _, vjp = jax.vjp(lambda v: jsc.random_grad(v, key),
                         jnp.asarray(x, jdt))
        (jg,) = vjp(jnp.asarray(cot, jdt))
        tx = torch.tensor(x, dtype=dt, requires_grad=True)
        sc.random_grad(tx, noise).backward(torch.tensor(cot, dtype=dt))
        assert np.array_equal(tx.grad.float().numpy(),
                              np.asarray(jg, np.float32)), dt


@pytest.mark.parametrize("active", [False, True])
def test_max_eig(active):
    """One step of MaxEig: the new direction and cur_prob, and the
    gradient (edited when the dominant direction holds >= 20% of the
    variance and the draw runs)."""
    x = _x(13, shape=(4, 12, 8))
    if active:
        x[..., 2] += 6 * _x(14, shape=(4, 12, 1))[..., 0]
    key = jax.random.PRNGKey(5)
    u = float(jax.random.uniform(key, ()))
    jstate = jsc.init_max_eig(8)
    jstate["cur_prob"] = jnp.float32(0.5 if u < 0.5 else 1.0)
    state = {k: torch.tensor(np.asarray(v)) for k, v in jstate.items()}
    cot = _x(15, x.shape)
    (jy, jnew), vjp = jax.vjp(lambda v: jsc.max_eig(jstate, v, key),
                              jnp.asarray(x))
    (jg,) = vjp((jnp.asarray(cot), jax.tree_util.tree_map(jnp.zeros_like,
                                                          jnew)))
    tx = torch.tensor(x, requires_grad=True)
    ty, new = sc.max_eig(state, tx, u)
    ty.backward(torch.tensor(cot))
    close(ty, jy, FWD)
    close(tx.grad, jg, BWD)
    close(new["direction"], jnew["direction"], BWD)
    assert new["cur_prob"].item() == pytest.approx(float(jnew["cur_prob"]))
    assert (float(jnew["cur_prob"]) == 1.0) == active
    if not active:
        assert np.array_equal(tx.grad.numpy(), cot)


@pytest.mark.parametrize("stride", [1, 2])
def test_scaled_conv1d(stride):
    p = jsc.init_scaled_conv1d(jax.random.PRNGKey(2), 6, 10, 5,
                               initial_scale=0.5)
    conv = sc.ScaledConv1d(6, 10, 5, initial_scale=0.5)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.asarray(p["w"]).transpose(2, 1,
                                                                    0)))
        conv.bias.copy_(torch.tensor(np.asarray(p["b"])))
    x = _x(16, shape=(2, 13, 6))
    cot_shape = (2, -(-13 // stride), 10)
    cot = _x(17, cot_shape)
    jy, vjp = jax.vjp(lambda v, w: jsc.scaled_conv1d(
        {"w": w, "b": p["b"]}, v, stride=stride), jnp.asarray(x), p["w"])
    jgx, jgw = vjp(jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    ty = sc.scaled_conv1d(conv, tx, stride=stride)
    ty.backward(torch.tensor(cot))
    close(ty, jy, FWD)
    close(tx.grad, jgx, BWD)
    close(conv.weight.grad, np.asarray(jgw).transpose(2, 1, 0), BWD)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_spectral_norm_layers(kind):
    """SRLinear / SRConv1d: the output, one power-iteration step of ``u``
    (and none in eval), and the gradients of the weight and sigma."""
    if kind == "linear":
        p, st = jsc.init_sr_linear(jax.random.PRNGKey(3), 12, 7)
        layer = sc.SRLinear(12, 7)
        w = np.asarray(p["w"]).T
        x = _x(18, shape=(3, 5, 12))

        def jf(v, w_, s_):
            return jsc.sr_linear(dict(p, w=w_, sigma=s_), st, v)

        tf = sc.sr_linear
    else:
        p, st = jsc.init_sr_conv1d(jax.random.PRNGKey(4), 4, 6, 3)
        layer = sc.SRConv1d(4, 6, 3)
        w = np.asarray(p["w"])
        x = _x(19, shape=(2, 9, 4))

        def jf(v, w_, s_):
            return jsc.sr_conv1d(dict(p, w=w_, sigma=s_), st, v,
                                 kernel_size=3)

        tf = sc.sr_conv1d
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(w))
        layer.bias.copy_(torch.tensor(np.asarray(p["b"])))
        layer.sigma.fill_(1.3)
        layer.u.copy_(torch.tensor(np.asarray(st["u"])))
    (jy, jst), vjp = jax.vjp(jf, jnp.asarray(x), p["w"],
                             jnp.full((1,), 1.3, jnp.float32))
    cot = _x(20, jy.shape)
    _, jgw, jgs = vjp((jnp.asarray(cot), jax.tree_util.tree_map(
        jnp.zeros_like, jst)))
    ty = tf(layer, torch.tensor(x))
    ty.backward(torch.tensor(cot))
    close(ty, jy, FWD)
    close(layer.u, jst["u"], BWD, "u")
    jgw = np.asarray(jgw)
    close(layer.weight.grad, jgw.T if kind == "linear" else jgw, BWD)
    close(layer.sigma.grad, jgs, BWD)
    u = layer.u.clone()
    with torch.no_grad():
        tf(layer, torch.tensor(x), training=False)
    assert torch.equal(layer.u, u)
