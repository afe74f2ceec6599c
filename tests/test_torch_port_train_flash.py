"""Training attention of the port on the CPU: the plain versions of the
flash forward and backward (``valle_tpu_torch/ops/flash_mha.py``) against
JAX ``flash_mha_train`` in interpret mode and its ``jax.vjp``, with the
same injected dropout bytes on both sides; the Philox byte generator; the
dropout estimator. The kernels themselves are held against these plain
versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances: fp32 1e-5 (rtol and atol; same math, another summation
order); bf16 2e-2 of the largest magnitude (each side rounds P, dS and the
outputs to bf16 at different points; chip_smoke's bf16 limit).

Rows that see no key are not compared: JAX pads T to a multiple of 128,
so such a row is uniform over the padded length there, and over T here.
None of these cases has one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.ops import masks as JM
from valle_tpu.ops.flash_mha import flash_mha_train as jax_flash
from valle_tpu_torch.ops import cuda_build as cb
from valle_tpu_torch.ops import masks as M
from valle_tpu_torch.ops.flash_mha import (flash_mha_backward,
                                           flash_mha_forward, flash_mha_train)
from valle_tpu_torch.ops.philox import (dropout_bytes, fold_seed,
                                        philox4x32_10)

from torch_port_helpers import t
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

B, H, D = 2, 2, 64


def _case(kind, seed=0):
    """(q, k, v numpy, JAX codes dict) for one mask family."""
    rng = np.random.RandomState(seed)
    if kind == "ar":
        S = 96
        qc, kc = JM.flash_codes_ar_xy(jnp.array([20, 32]), jnp.array([50, 64]),
                                      32, S - 32)
        codes = {"qcode": qc, "kcode": kc}
    elif kind == "padding":
        S = 80
        qc, kc = JM.flash_codes_padding(jnp.array([20, 32]),
                                        jnp.array([40, 48]), 32, S - 32)
        codes = {"qcode": qc, "kcode": kc}
    elif kind == "key_valid":
        S = 72
        kk = np.arange(S)[None]
        key_valid = np.where(kk < 24, kk < np.array([[10], [24]]),
                             np.where(kk < 40, (kk - 24) < np.array([[16],
                                                                     [9]]),
                                      (kk - 40) < np.array([[32], [20]])))
        qc, kc = JM.flash_codes_key_valid(jnp.asarray(key_valid))
        codes = {"qcode": qc, "kcode": kc}
    else:  # packed rows: segments and the always-visible diagonal
        text_seg = jnp.array([[0, 0, 0, 1, 1, -1, -1, -1] * 4] * B)
        audio_seg = jnp.array([[0, 0, 0, 0, 1, 1, -1, -1] * 6] * B)
        S = 32 + 48
        qc, kc, qs, ks = JM.flash_codes_packed_ar(text_seg, audio_seg)
        codes = {"qcode": qc, "kcode": kc, "qseg": qs, "kseg": ks,
                 "add_diag": True}
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    bits = rng.randint(0, 256, (B, H, S, S)).astype(np.uint8)
    return q, k, v, g, bits, codes


def _jax_fwd_vjp(q, k, v, g, bits, codes, rate, dtype):
    c = dict(codes)
    qc, kc = c.pop("qcode"), c.pop("kcode")

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, qc, kc, dropout_rate=rate,
                         debug_bits=jnp.asarray(bits) if rate else None,
                         interpret=True, **c)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(x, np.float32)
            for x in (out, *vjp(jnp.asarray(g, dtype)))]


def _port_codes(codes):
    return {n: (t(v, torch.int32) if n != "add_diag" else v)
            for n, v in codes.items()}


def _close(got, ref, dtype):
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), err


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["ar", "padding", "key_valid", "packed"])
def test_flash_train_plain_matches_jax(kind, rate):
    """fp32: out of the forward wrapper, and dq, dk, dv of both the
    backward wrapper and autograd through flash_mha_train."""
    q, k, v, g, bits, codes = _case(kind)
    ref = _jax_fwd_vjp(q, k, v, g, bits, codes, rate, jnp.float32)
    pc = _port_codes(codes)
    qc, kc = pc.pop("qcode"), pc.pop("kcode")
    drop = dict(dropout_rate=rate, bits=t(bits) if rate else None)
    out, lse = flash_mha_forward(t(q), t(k), t(v), qc, kc, **pc, **drop)
    grads = flash_mha_backward(t(q), t(k), t(v), qc, kc, out, lse, t(g),
                               **pc, **drop)
    for got, want in zip((out, *grads), ref):
        _close(got.numpy(), want, jnp.float32)
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    out2 = flash_mha_train(*qkv, qc, kc, **pc, **drop)
    out2.backward(t(g))
    for got, want in zip((out2.detach(), *(x.grad for x in qkv)), ref):
        _close(got.numpy(), want, jnp.float32)


def test_flash_train_plain_matches_jax_head_dim_128():
    """Dh 128 (d_model 1024 with 8 heads), B 1, H 1, S = T = 130 (two key
    tiles of the kernels, one ragged): the plain forward and backward
    against JAX interpret with the same injected dropout bytes, fp32."""
    rng = np.random.RandomState(128)
    S = 130
    qc, kc = JM.flash_codes_ar_xy(jnp.array([30]), jnp.array([90]), 34,
                                  S - 34)
    codes = {"qcode": qc, "kcode": kc}
    q, k, v, g = (rng.randn(1, 1, S, 128).astype(np.float32)
                  for _ in range(4))
    bits = rng.randint(0, 256, (1, 1, S, S)).astype(np.uint8)
    ref = _jax_fwd_vjp(q, k, v, g, bits, codes, 0.1, jnp.float32)
    pc = _port_codes(codes)
    drop = dict(dropout_rate=0.1, bits=t(bits))
    out, lse = flash_mha_forward(t(q), t(k), t(v), pc["qcode"], pc["kcode"],
                                 **drop)
    grads = flash_mha_backward(t(q), t(k), t(v), pc["qcode"], pc["kcode"],
                               out, lse, t(g), **drop)
    for got, want in zip((out, *grads), ref):
        _close(got.numpy(), want, jnp.float32)


@pytest.mark.parametrize("kind", ["ar", "packed"])
def test_flash_train_plain_matches_jax_bf16(kind):
    q, k, v, g, bits, codes = _case(kind, seed=1)
    ref = _jax_fwd_vjp(q, k, v, g, bits, codes, 0.1, jnp.bfloat16)
    pc = _port_codes(codes)
    qc, kc = pc.pop("qcode"), pc.pop("kcode")
    qkv = [t(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = flash_mha_train(*qkv, qc, kc, **pc, dropout_rate=0.1, bits=t(bits))
    out.backward(t(g).to(torch.bfloat16))
    for got, want in zip((out.detach(), *(x.grad for x in qkv)), ref):
        _close(got.float().numpy(), want, jnp.bfloat16)


def test_flash_seed_equals_its_bytes():
    """A seed and the Philox bytes it stands for give the same result."""
    q, k, v, g, bits, codes = _case("ar")
    qc, kc = t(codes["qcode"]), t(codes["kcode"])
    S = q.shape[2]
    a = flash_mha_train(t(q), t(k), t(v), qc, kc, dropout_rate=0.1, seed=7)
    b = flash_mha_train(t(q), t(k), t(v), qc, kc, dropout_rate=0.1,
                        bits=dropout_bytes(7, B, H, S, S))
    assert torch.equal(a, b)


@pytest.mark.parametrize("builder", ["padding_attn_bias", "flash_codes_ar_xy",
                                     "flash_codes_padding"])
def test_mask_builders_match_jax(builder):
    x_lens, y_lens = np.array([5, 9]), np.array([20, 13])
    ref = getattr(JM, builder)(jnp.asarray(x_lens), jnp.asarray(y_lens), 9,
                               20)
    got = getattr(M, builder)(t(x_lens), t(y_lens), 9, 20)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = philox4x32_10(*(torch.tensor(c) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_dropout_bytes_layout():
    """Byte (b, h, i, j) is byte j % 16 of philox((b*H + h, i, j // 16, 0),
    key = the seed's words), little-endian in each word."""
    seed = (0x1234 << 32) | 0x5678
    Bb, Hh, S, T = 2, 3, 4, 37
    got = dropout_bytes(seed, Bb, Hh, S, T)
    for b, h, i, j in [(0, 0, 0, 0), (1, 2, 3, 36), (1, 0, 2, 17)]:
        words = philox4x32_10(*(torch.tensor(c) for c in
                                (b * Hh + h, i, j // 16, 0)), 0x5678, 0x1234)
        w = int(words[(j % 16) // 4])
        assert int(got[b, h, i, j]) == (w >> (8 * (j % 4))) & 255


def test_dropout_estimator():
    """Keep rate and rescale of the 8-bit rule, determinism per seed: the
    mean of dropped ones stays 1 and the keep share is 1 - 26/256."""
    from valle_tpu_torch.modules.embedding import dropout

    x = torch.ones(256, 1024)
    a, b = dropout(x, 0.1, seed=3), dropout(x, 0.1, seed=3)
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.1, seed=4))
    kept = (a != 0).float().mean().item()
    assert abs(kept - (1 - 26 / 256)) < 5e-3
    assert torch.allclose(a[a != 0], torch.tensor(256 / 230))
    assert abs(a.mean().item() - 1.0) < 1e-2
    assert dropout(x, 0.1, seed=None) is x
    assert fold_seed(5, 0) != fold_seed(5, 1) != fold_seed(6, 0)
    keep = dropout_bytes(11, 4, 4, 64, 64) >= 26
    assert abs(keep.float().mean().item() - (1 - 26 / 256)) < 1e-2


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_backward_raises_on_other_devices():
    x = _meta(1, 2, 8, 64)
    c = _meta(1, 8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no kernel for devices"):
        flash_mha_backward(x, x, x, c, c, x, _meta(1, 2, 8), x)


def test_cpu_training_calls_never_launch():
    cb.reset_launch_counts()
    q, k, v, g, bits, codes = _case("padding")
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    flash_mha_train(*qkv, t(codes["qcode"]), t(codes["kcode"]),
                    dropout_rate=0.1, seed=1).sum().backward()
    assert all(n == 0 for n in cb.LAUNCHES.values())
