"""The port's kernels: plain versions vs the JAX Pallas kernels (interpret
mode) at fp32, and the dispatch rules. The kernels themselves are checked
on the card by tests/test_torch_port_cuda.py and chip_smoke.py.

Tolerances are the JAX package's own: fused dense 1e-5 (int8 weights
1e-4, tests/test_fused_dense.py), flash forward atol 2e-5
(tests/test_flash_mha.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.ops import fused_dense as jfd
from valle_tpu.ops import masks as JM
from valle_tpu.ops.flash_mha import flash_mha_train
from valle_tpu_torch.ops import cuda_build as cb
from valle_tpu_torch.ops import fused_dense as fd
from valle_tpu_torch.ops.flash_mha import flash_mha_forward, reference_mha

from torch_port_helpers import t
from torch_port_helpers import one_thread  # noqa: F401  (autouse)


def _dense_case(seed, B=4, D=128, F=512):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    return {"h": f(B, D), "a": f(B, D), "ln_w": 1 + f(D, sc=0.1),
            "ln_b": f(D, sc=0.1), "in_w": f(D, 3 * D, sc=0.1),
            "in_b": f(3 * D, sc=0.1), "out_w": f(D, D, sc=0.1),
            "out_b": f(D, sc=0.1), "w1": f(D, F, sc=0.1), "b1": f(F, sc=0.1),
            "w2": f(F, D, sc=0.1), "b2": f(D, sc=0.1)}


def _jax_w(x, int8):
    """JAX layout (1, in, out) stacked weight, optionally int8 + scale."""
    w = jnp.asarray(x)[None]
    if not int8:
        return w, None
    wq, s = jfd.quantize_weights_per_channel(w)
    return wq, s[0]


def _port_w(x, int8):
    """The same weight in PyTorch's (out, in) layout for the port."""
    w = t(x.T.copy())
    return fd.quantize_weights_per_channel(w) if int8 else (w, None)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_ln_qkv_plain_matches_jax(int8):
    c = _dense_case(0)
    jw, js = _jax_w(c["in_w"], int8)
    ref = jfd.fused_ln_qkv(jnp.asarray(c["h"]), jnp.asarray(c["ln_w"]),
                           jnp.asarray(c["ln_b"]), jw, jnp.asarray(c["in_b"]),
                           0, w_scale=js, interpret=True)
    pw, ps = _port_w(c["in_w"], int8)
    out = fd.fused_ln_qkv(t(c["h"]), t(c["ln_w"]), t(c["ln_b"]), pw,
                          t(c["in_b"]), w_scale=ps)
    tol = 1e-4 if int8 else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("activation,int8", [("relu", False),
                                             ("gelu", False),
                                             ("relu", True)])
def test_fused_tail_plain_matches_jax(activation, int8):
    c = _dense_case(1)
    jws = [_jax_w(c[n], int8) for n in ("out_w", "w1", "w2")]
    ref = jfd.fused_tail(
        jnp.asarray(c["a"]), jnp.asarray(c["h"]), jws[0][0],
        jnp.asarray(c["out_b"]), jnp.asarray(c["ln_w"]),
        jnp.asarray(c["ln_b"]), jws[1][0], jnp.asarray(c["b1"]), jws[2][0],
        jnp.asarray(c["b2"]), 0, activation=activation,
        w_scales=tuple(s for _, s in jws) if int8 else None, interpret=True)
    pws = [_port_w(c[n], int8) for n in ("out_w", "w1", "w2")]
    out = fd.fused_tail(
        t(c["a"]), t(c["h"]), pws[0][0], t(c["out_b"]), t(c["ln_w"]),
        t(c["ln_b"]), pws[1][0], t(c["b1"]), pws[2][0], t(c["b2"]),
        activation=activation,
        w_scales=tuple(s for _, s in pws) if int8 else None)
    tol = 1e-4 if int8 else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_quantize_weights_per_channel_matches_jax():
    w = _dense_case(2)["w1"]                       # (in, out)
    jq, js = jfd.quantize_weights_per_channel(jnp.asarray(w))
    pq, ps = fd.quantize_weights_per_channel(t(w.T.copy()))
    assert np.array_equal(pq.numpy(), np.asarray(jq).T)
    assert np.array_equal(ps.numpy(), np.asarray(js))


def _flash_case(kind, seed=0):
    """(q, k, v numpy, JAX codes dict) for one of the mask families."""
    rng = np.random.RandomState(seed)
    B, H, D = 2, 2, 64
    if kind == "ar":
        S = 200
        x_lens, y_lens = jnp.array([40, 64]), jnp.array([100, 130])
        qc, kc = JM.flash_codes_ar_xy(x_lens, y_lens, 64, S - 64)
        codes = {"qcode": qc, "kcode": kc}
    elif kind == "nar":
        S = 160
        kk = np.arange(S)[None]
        key_valid = np.where(kk < 64, kk < np.array([[40], [64]]),
                             (kk - 64) < np.array([[80], [96]]))
        qc, kc = JM.flash_codes_key_valid(jnp.asarray(key_valid))
        codes = {"qcode": qc, "kcode": kc}
    else:
        text_seg = jnp.array([[0, 0, 0, 1, 1, -1, -1, -1] * 8] * B)
        audio_seg = jnp.array([[0, 0, 0, 0, 1, 1, -1, -1] * 12] * B)
        S = 64 + 96
        build = (JM.flash_codes_packed_ar if kind == "packed_ar"
                 else JM.flash_codes_packed_nar)
        qc, kc, qs, ks = build(text_seg, audio_seg)
        codes = {"qcode": qc, "kcode": kc, "qseg": qs, "kseg": ks,
                 "add_diag": True}
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    return q, k, v, codes


def _port_codes(codes):
    return {n: (t(v, torch.int32) if n != "add_diag" else v)
            for n, v in codes.items()}


@pytest.mark.parametrize("kind", ["ar", "nar", "packed_ar", "packed_nar"])
def test_flash_plain_matches_jax(kind):
    q, k, v, codes = _flash_case(kind)
    ref = flash_mha_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          codes["qcode"], codes["kcode"],
                          qseg=codes.get("qseg"), kseg=codes.get("kseg"),
                          add_diag=codes.get("add_diag", False),
                          interpret=True)
    pc = _port_codes(codes)
    out, lse = flash_mha_forward(t(q), t(k), t(v), pc.pop("qcode"),
                                 pc.pop("kcode"), **pc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert lse.shape == q.shape[:3] and torch.isfinite(lse).all()


def test_flash_lse_matches_jax_scores():
    q, k, v, codes = _flash_case("ar")
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    vis = codes["kcode"][:, None, :] <= codes["qcode"][:, :, None]
    ref = jax.nn.logsumexp(jnp.where(vis[:, None], s, -1e30), axis=-1)
    _, lse = flash_mha_forward(t(q), t(k), t(v), t(codes["qcode"]),
                               t(codes["kcode"]))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_flash_dropout_is_not_ported():
    """Dropout is ported now (tests/test_torch_port_train_flash.py); what
    stays refused is dropout with neither a seed nor explicit bytes."""
    q, k, v, codes = _flash_case("nar")
    with pytest.raises(ValueError, match="seed or explicit bits"):
        flash_mha_forward(t(q), t(k), t(v), t(codes["qcode"]),
                          t(codes["kcode"]), dropout_rate=0.1)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrapper", ["fused_ln_qkv", "fused_tail",
                                     "flash_mha_fwd"])
def test_wrappers_raise_on_other_devices(wrapper):
    """A tensor that is neither on the CPU nor on CUDA reaches no plain
    version and no kernel: the wrapper raises."""
    D = 128
    with pytest.raises(RuntimeError, match="no kernel for devices"):
        if wrapper == "fused_ln_qkv":
            fd.fused_ln_qkv(_meta(2, D), _meta(D), _meta(D), _meta(3 * D, D),
                            _meta(3 * D))
        elif wrapper == "fused_tail":
            fd.fused_tail(_meta(2, D), _meta(2, D), _meta(D, D), _meta(D),
                          _meta(D), _meta(D), _meta(4 * D, D), _meta(4 * D),
                          _meta(D, 4 * D), _meta(D))
        else:
            x = _meta(1, 2, 8, 64)
            c = _meta(1, 8, dtype=torch.int32)
            flash_mha_forward(x, x, x, c, c)


def test_cpu_calls_never_launch():
    cb.reset_launch_counts()
    c = _dense_case(3)
    fd.fused_ln_qkv(t(c["h"]), t(c["ln_w"]), t(c["ln_b"]),
                    t(c["in_w"].T.copy()), t(c["in_b"]))
    assert all(n == 0 for n in cb.LAUNCHES.values())
