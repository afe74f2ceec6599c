"""Kernels B6 (``flash_attention``) and B7 (``flash_attention_lens``) of the
port against the JAX package's, on the same numpy inputs (fp32, JAX's
Pallas kernels in interpret mode, the port's plain versions on the CPU):
forward to 2e-5 and gradients to 2e-4, JAX's own tolerances
(tests/test_attention.py:31-51); ``fused_attention``'s rule and the
switch's route through ``attend``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.ops import attention as ja
from valle_tpu.ops import masks as JM
from valle_tpu_torch.modules.transformer import attend
from valle_tpu_torch.ops import attention as pa
from valle_tpu_torch.ops import cuda_build as cb

from torch_port_helpers import t
from torch_port_helpers import one_thread  # noqa: F401  (autouse)


def _inputs(B=2, H=4, S=256, T=256, D=64, seed=0, causal=True):
    """q, k, v and the bias of tests/test_attention.py:make_inputs: row 1's
    keys past 0.7 T masked, plus the causal mask when S == T."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32) for n in (S, T, T))
    lens = np.array([T, int(T * 0.7)][:B])
    bias = np.where(np.arange(T)[None] < lens[:, None], 0.0,
                    -np.inf)[:, None, None, :]
    if S == T and causal:
        pos = np.arange(S)
        bias = bias + np.where(pos[None] <= pos[:, None], 0.0, -np.inf)
    return q, k, v, np.broadcast_to(bias, (B, 1, S, T)).astype(np.float32)


def _grads(fn, q, k, v):
    """(out, dq, dk, dv) of sum(fn(q, k, v) ** 2) on the port's side."""
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    out = fn(*qkv)
    (out ** 2).sum().backward()
    return [out.detach().numpy()] + [x.grad.numpy() for x in qkv]


def _jax_grads(fn, q, k, v):
    out = fn(*(jnp.asarray(x) for x in (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _assert_fwd_bwd(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)


def test_flash_attention_matches_jax_forward_and_grads():
    q, k, v, bias = _inputs()
    jb = jnp.asarray(bias)
    want = _jax_grads(lambda *a: ja.flash_attention(*a, jb, 128, 128, True),
                      q, k, v)
    got = _grads(lambda *a: pa.flash_attention(*a, t(bias)), q, k, v)
    _assert_fwd_bwd(got, want)


@pytest.mark.parametrize("bias_shape", ["full", "key"])
def test_fused_attention_odd_shapes_match_jax(bias_shape):
    """S 200, T 333 (JAX pads both to its tiles, the port masks the ragged
    edges); the bias as (B, 1, S, T) or as the NAR's (B, 1, 1, T) key
    bias, which JAX broadcasts and the port's kernel reads with stride
    0."""
    q, k, v, bias = _inputs(S=200, T=333)
    if bias_shape == "key":
        bias = np.ascontiguousarray(bias[:, :, :1])
    want = ja.fused_attention(*(jnp.asarray(x) for x in (q, k, v, bias)),
                              use_pallas=True, interpret=True)
    got = pa.fused_attention(*(t(x) for x in (q, k, v, bias)),
                             use_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_fully_masked_row_stays_finite():
    """tests/test_attention.py:54-61: row 5 of sample 0 sees no key. At T
    128 JAX pads nothing, so every row, the masked one included (uniform
    over the T keys), matches JAX's."""
    q, k, v, _ = _inputs(S=128, T=128)
    bias = np.full((2, 1, 128, 128), -np.inf, np.float32)
    bias[..., :4] = 0.0
    bias[0, :, 5] = -np.inf
    got = pa.fused_attention(*(t(x) for x in (q, k, v, bias)),
                             use_kernel=True)
    assert torch.isfinite(got).all()
    want = ja.fused_attention(*(jnp.asarray(x) for x in (q, k, v, bias)),
                              use_pallas=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    # the plain route (no clamp) is JAX's naive_attention: NaN there
    assert torch.isnan(pa.naive_attention(*(t(x) for x in (q, k, v, bias)))
                       [0, :, 5]).all()


@pytest.mark.parametrize("audio_causal", [True, False])
def test_flash_attention_lens_matches_jax(audio_causal):
    """tests/test_attention.py:356-390: [text 128; audio 128], the AR
    composite mask (causal) or the NAR padding mask, with gradients."""
    B, H, St, Ta, D = 2, 4, 128, 128, 64
    q, k, v, _ = _inputs(B, H, St + Ta, St + Ta, D, seed=3)
    x_lens, y_lens = np.array([St, 70]), np.array([Ta, 90])
    jl = (jnp.asarray(x_lens), jnp.asarray(y_lens))
    want = _jax_grads(lambda *a: ja.flash_attention_lens(
        *a, *jl, St, audio_causal, 128, 128, True), q, k, v)
    got = _grads(lambda *a: pa.flash_attention_lens(
        *a, t(x_lens), t(y_lens), St, audio_causal), q, k, v)
    _assert_fwd_bwd(got, want)
    # the plain version is attention under the JAX package's bias arrays
    mk = JM.ar_xy_attn_bias if audio_causal else JM.padding_attn_bias
    ref = ja.naive_attention(*(jnp.asarray(x) for x in (q, k, v)),
                             mk(*jl, St, Ta))
    np.testing.assert_allclose(got[0], np.asarray(ref), rtol=0, atol=2e-5)


def test_head_dim_128_matches_jax():
    """Dh 128, the kernels' other head dim: B6 (forward and gradients) and
    B7 (the AR composite mask) plain against JAX's kernels in interpret
    mode, at the tolerances above."""
    q, k, v, bias = _inputs(B=2, H=1, S=128, T=128, D=128, seed=7)
    jb = jnp.asarray(bias)
    want = _jax_grads(lambda *a: ja.flash_attention(*a, jb, 128, 128, True),
                      q, k, v)
    _assert_fwd_bwd(_grads(lambda *a: pa.flash_attention(*a, t(bias)), q, k,
                           v), want)
    St = 64
    x_lens, y_lens = np.array([St, 20]), np.array([64, 0])
    want = ja.flash_attention_lens(*(jnp.asarray(x) for x in (q, k, v)),
                                   jnp.asarray(x_lens), jnp.asarray(y_lens),
                                   St, True, 128, 128, True)
    got = pa.flash_attention_lens(*(t(x) for x in (q, k, v)), t(x_lens),
                                  t(y_lens), St, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_switch_on_cpu_keeps_the_plain_route(monkeypatch):
    """Under VALLE_TPU_FLASH_ATTENTION=1 a CPU tensor still takes
    ``naive_attention`` (JAX: the CPU backend never takes the kernel), so
    ``attend`` is unchanged and no kernel launch is counted; the rule's
    other conditions hold as in JAX."""
    q, k, v, bias = (t(x) for x in _inputs(S=128, T=128))
    monkeypatch.setenv("VALLE_TPU_FLASH_ATTENTION", "1")
    before = dict(cb.LAUNCHES)
    got = attend(q, k, v, bias)
    assert torch.equal(got, pa.naive_attention(q, k, v, bias))
    assert cb.LAUNCHES == before
    assert not pa.use_flash_kernel(q, k)
    meta = [x.to("meta") for x in (q, k)]
    assert pa.use_flash_kernel(*meta) is False          # not CUDA
    # with dropout live or bf16 scores attend keeps its own einsum route
    s16 = attend(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias,
                 score_bf16=True)
    assert s16.dtype == torch.bfloat16
    monkeypatch.delenv("VALLE_TPU_FLASH_ATTENTION")
    assert torch.equal(attend(q, k, v, bias), got)


def test_wrappers_refuse_other_devices():
    q, k, v, bias = (t(x).to("meta") for x in _inputs(S=128, T=128))
    with pytest.raises(RuntimeError, match="no kernel for devices"):
        pa.flash_attention(q, k, v, bias)
    with pytest.raises(RuntimeError, match="no kernel for devices"):
        pa.flash_attention_lens(q, k, v, torch.ones(2, device="meta"),
                                torch.ones(2, device="meta"), 64)
