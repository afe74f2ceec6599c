"""The port's optimizers and schedules against the JAX package's.

ScaledAdam: the shape of tests/test_scaled_adam.py:run_pair with JAX as
the other arm: identical parameters and gradients g = (p - target) * scale
for 35 steps, a gradient spike at step 25 after the clipping threshold is
estimated (clipping_update_period 10). Leaves: one stacked (3, 6, 5) JAX
leaf against three separate port tensors, a matrix, a vector and a scalar.
Tolerances: fp32 state 1e-5 relative (the scalar coefficients are computed
in float64 here and in float32 by XLA); bf16 state 5e-3 relative (the same
1e-7 differences can flip the rounding of a stored bf16 value, one bf16
ulp of the update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.optim import eden_lr as jax_eden
from valle_tpu.optim import eve as jax_eve
from valle_tpu.optim import noam_lr as jax_noam
from valle_tpu.optim import scaled_adam as jax_scaled_adam
from valle_tpu_torch.optim.eve import Eve
from valle_tpu_torch.optim.scaled_adam import ScaledAdam
from valle_tpu_torch.optim.schedules import eden_lr, noam_lr

STEPS = 35
SHAPES = [(3, 6, 5), (10, 8), (16,), (1,)]   # first leaf: stacked in JAX


def run_pair(make_port, make_jax, steps=STEPS):
    rng = np.random.RandomState(0)
    j_params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    targets = [p - 5.0 for p in j_params]
    # port: the stacked leaf becomes its three slices
    t_params = [torch.nn.Parameter(torch.from_numpy(x.copy()))
                for x in [*j_params[0], *j_params[1:]]]
    t_targets = [torch.from_numpy(x.copy())
                 for x in [*targets[0], *targets[1:]]]
    opt = make_jax()
    state = opt.init([jnp.asarray(p) for p in j_params])

    @jax.jit
    def jstep(params, state, scale):
        grads = [(p - jnp.asarray(tg)) * scale
                 for p, tg in zip(params, targets)]
        upd, state = opt.update(grads, state, params)
        return [p + u for p, u in zip(params, upd)], state

    jp = [jnp.asarray(p) for p in j_params]
    port = make_port(t_params)
    for i in range(steps):
        scale = 3.0 if i == 25 else 1.0
        jp, state = jstep(jp, state, jnp.float32(scale))
        for p, tg in zip(t_params, t_targets):
            p.grad = (p.detach() - tg) * scale
        port.step()
    got = [torch.stack([p.detach() for p in t_params[:3]]).numpy(),
           *(p.detach().numpy() for p in t_params[3:])]
    return got, [np.asarray(p) for p in jp], port


@pytest.mark.parametrize("clipping_scale", [None, 2.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_scaled_adam_matches_jax(clipping_scale, state_dtype):
    def make_jax():
        return jax_scaled_adam(
            learning_rate=0.03, clipping_scale=clipping_scale,
            clipping_update_period=10,
            stacked_fn=lambda path: path[0].idx == 0,
            state_dtype=jnp.dtype(state_dtype))

    def make_port(params):
        return ScaledAdam(params, lr=0.03, clipping_scale=clipping_scale,
                          clipping_update_period=10,
                          state_dtype=getattr(torch, state_dtype))

    got, want, port = run_pair(make_port, make_jax)
    tol = 1e-5 if state_dtype == "float32" else 5e-3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    if clipping_scale is not None:
        # the spike at step 25 was clipped
        assert int(port.num_clipped) >= 1
    assert port.state[port.param_groups[0]["params"][0]]["delta"].dtype == (
        getattr(torch, state_dtype))


def test_eve_matches_jax():
    got, want, _ = run_pair(lambda ps: Eve(ps, lr=1e-3),
                            lambda: jax_eve(learning_rate=1e-3))
    # Eve's decay reads the whole stacked leaf's norm in JAX: compare the
    # unstacked leaves only
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_schedules_match_jax():
    for epoch in (0, 1, 3):
        for batch in (0, 100, 500, 5000):
            np.testing.assert_allclose(
                eden_lr(0.05, batch, epoch, lr_batches=5000, lr_epochs=4,
                        warmup_batches=200),
                float(jax_eden(0.05, batch, epoch, lr_batches=5000,
                               lr_epochs=4, warmup_batches=200)), rtol=1e-6)
    for step in (0, 1, 10, 200, 4000):
        np.testing.assert_allclose(
            noam_lr(0.05, step, dim_embed=1024, warmup_steps=200),
            float(jax_noam(0.05, step, dim_embed=1024, warmup_steps=200)),
            rtol=1e-6)
