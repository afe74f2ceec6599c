"""The decode-attention modules of the port against the JAX package's, on
the same numpy inputs (fp32, JAX's Pallas kernels in interpret mode):
the plain versions of B3/B10/B11/B12, the cache layouts bit for bit, the
int8 cache conversion, the dispatch rule and ``resolve_decode_mode``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from valle_tpu.modules import transformer as jtfm
from valle_tpu.ops import decode_attention_int8_grouped as j8
from valle_tpu.ops import decode_attention_kv as jkv
from valle_tpu.ops import decode_attention_lanes as jln
from valle_tpu.ops.fused_attn_tail import fused_attn_tail as jax_attn_tail
from valle_tpu_torch.models import inference as I
from valle_tpu_torch.models.valle import ValleConfig
from valle_tpu_torch.modules.transformer import quantize_kv
from valle_tpu_torch.ops import decode_attention_int8_grouped as p8
from valle_tpu_torch.ops import decode_attention_kv as pkv
from valle_tpu_torch.ops import decode_attention_lanes as pln
from valle_tpu_torch.ops.fused_attn_tail import fused_attn_tail

from torch_port_helpers import t
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

# the JAX package's oracle shapes (tests/test_attention.py:132-140)
B, H, T, DH, S = 8, 4, 512, 64, 40
X_LENS = np.array([40, 25, 10, 33, 7, 40, 18, 2], np.int32)
WRITE_POS = np.array([300, 120, 60, 440, 95, 511, 200, 47], np.int32)


def _qkv(seed=0, H=H, Dh=DH):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, H, 1, Dh), (B, H, T, Dh), (B, H, T, Dh))]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_int8_plain_matches_jax_kernel():
    q, k, v = _qkv()
    jkq, jks = jtfm.quantize_kv(jnp.asarray(k))
    jvq, jvs = jtfm.quantize_kv(jnp.asarray(v))
    kv, sc = j8.combine_kv_int8(jkq, jvq), j8.stack_scales(jks, jvs)
    ref = j8.decode_attention_int8_grouped(
        *_j(q), kv, sc, *_j(X_LENS, WRITE_POS), S=S, interpret=True)
    got = p8.decode_attention_int8_grouped(
        t(q), t(kv), t(sc), t(X_LENS), t(WRITE_POS), S=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)


def test_kv_plain_matches_jax_kernel():
    q, k, v = _qkv()
    kv = np.asarray(jkv.combine_kv(*_j(k, v)))
    ref = jkv.decode_attention_kv(*_j(q, kv, X_LENS, WRITE_POS), S=S,
                                  interpret=True)
    got = pkv.decode_attention_kv(t(q), t(kv), t(X_LENS), t(WRITE_POS), S=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


def test_lanes_plain_matches_jax_kernel():
    q, k, v = _qkv()
    kv = np.asarray(jln.combine_kv_lanes(*_j(k, v)))
    ref = jln.decode_attention_lanes(*_j(q, kv, X_LENS, WRITE_POS), S=S,
                                     nhead=H, interpret=True)
    got = pln.decode_attention_lanes(t(q), t(kv), t(X_LENS), t(WRITE_POS),
                                     S=S, nhead=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_attn_tail_plain_matches_jax_kernel(activation):
    """d 128 (H 4, Dh 32), F 512: the JAX kernel takes stacked (L, in, out)
    weights and a layer index, the port one layer in (out, in)."""
    D, F, Hd, L, layer = 128, 512, 4, 2, 1
    q, k, v = _qkv(seed=1, H=Hd, Dh=D // Hd)
    rng = np.random.RandomState(2)
    h = rng.randn(B, D).astype(np.float32)
    w = {n: (rng.randn(L, a, b) * a ** -0.5).astype(np.float32)
         for n, a, b in (("out", D, D), ("w1", D, F), ("w2", F, D))}
    vec = {n: (0.1 * rng.randn(n_)).astype(np.float32)
           for n, n_ in (("out_b", D), ("ln_b", D), ("b1", F), ("b2", D))}
    vec["ln_w"] = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    kv = np.asarray(jln.combine_kv_lanes(*_j(k, v)))
    ref = jax_attn_tail(
        *_j(q, h, kv, X_LENS, WRITE_POS), layer, jnp.asarray(w["out"]),
        *_j(vec["out_b"], vec["ln_w"], vec["ln_b"]), jnp.asarray(w["w1"]),
        jnp.asarray(vec["b1"]), jnp.asarray(w["w2"]), jnp.asarray(vec["b2"]),
        S=S, activation=activation, interpret=True)
    tw = {n: t(np.ascontiguousarray(a[layer].T)) for n, a in w.items()}
    got = fused_attn_tail(
        t(q), t(h), t(kv), t(X_LENS), t(WRITE_POS), tw["out"], t(vec["out_b"]),
        t(vec["ln_w"]), t(vec["ln_b"]), tw["w1"], t(vec["b1"]), tw["w2"],
        t(vec["b2"]), S=S, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["int8", "kv", "lanes", "attn_tail"])
def test_plain_matches_jax_kernel_at_head_dim_128(kernel):
    """B3, B10, B11 and B12 at Dh 128 (H 2, cache 256): the head dim that
    d_model 1024 with 8 heads gives, which the CUDA kernels also take."""
    Hd, Dh, Tc = 2, 128, 256
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, Hd, n, Dh).astype(np.float32)
               for n in (1, Tc, Tc))
    lens = (X_LENS, np.minimum(WRITE_POS, Tc - 1))
    if kernel == "int8":
        jkq, jks = jtfm.quantize_kv(jnp.asarray(k))
        jvq, jvs = jtfm.quantize_kv(jnp.asarray(v))
        kv, sc = j8.combine_kv_int8(jkq, jvq), j8.stack_scales(jks, jvs)
        ref = j8.decode_attention_int8_grouped(
            *_j(q), kv, sc, *_j(*lens), S=S, interpret=True)
        got = p8.decode_attention_int8_grouped(
            t(q), t(kv), t(sc), *map(t, lens), S=S)
        atol = 2e-5
    elif kernel == "kv":
        kv = np.asarray(jkv.combine_kv(*_j(k, v)))
        ref = jkv.decode_attention_kv(*_j(q, kv, *lens), S=S,
                                      interpret=True)
        got = pkv.decode_attention_kv(t(q), t(kv), *map(t, lens), S=S)
        atol = 2e-6
    elif kernel == "lanes":
        kv = np.asarray(jln.combine_kv_lanes(*_j(k, v)))
        ref = jln.decode_attention_lanes(*_j(q, kv, *lens), S=S, nhead=Hd,
                                         interpret=True)
        got = pln.decode_attention_lanes(t(q), t(kv), *map(t, lens), S=S,
                                         nhead=Hd)
        atol = 2e-6
    else:
        D, F = Hd * Dh, 512
        h = rng.randn(B, D).astype(np.float32)
        w = {n: (rng.randn(1, a, b_) * a ** -0.5).astype(np.float32)
             for n, a, b_ in (("out", D, D), ("w1", D, F), ("w2", F, D))}
        vec = [(0.1 * rng.randn(n_)).astype(np.float32)
               for n_ in (D, D, D, F, D)]
        vec[1] += 1   # ln_w
        kv = np.asarray(jln.combine_kv_lanes(*_j(k, v)))
        ref = jax_attn_tail(
            *_j(q, h, kv, *lens), 0, jnp.asarray(w["out"]),
            *_j(*vec[:3]), jnp.asarray(w["w1"]), jnp.asarray(vec[3]),
            jnp.asarray(w["w2"]), jnp.asarray(vec[4]), S=S, interpret=True)
        tw = {n: t(np.ascontiguousarray(a[0].T)) for n, a in w.items()}
        got = fused_attn_tail(
            t(q), t(h), t(kv), *map(t, lens), tw["out"], t(vec[0]),
            t(vec[1]), t(vec[2]), tw["w1"], t(vec[3]), tw["w2"], t(vec[4]),
            S=S)
        atol = 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5 if kernel == "attn_tail" else 0,
                               atol=atol)


def test_cache_layouts_bit_equal_jax():
    rng = np.random.RandomState(3)
    k, v = (rng.randn(2, B, H, 64, DH).astype(np.float32) for _ in range(2))
    k[..., 40:, :] = 0.0                     # unwritten rows: scale 1e-8
    for x in (k, v, k.astype(np.float32) * 1e-3):
        jq, js = jtfm.quantize_kv(jnp.asarray(x))
        pq, ps = quantize_kv(t(x))
        assert np.array_equal(pq.numpy(), np.asarray(jq))
        assert np.array_equal(ps.numpy(), np.asarray(js))
    jq_k, js_k = jtfm.quantize_kv(jnp.asarray(k))
    jq_v, js_v = jtfm.quantize_kv(jnp.asarray(v))
    pairs = [
        (p8.combine_kv_int8(t(jq_k), t(jq_v)), j8.combine_kv_int8(jq_k, jq_v)),
        (p8.stack_scales(t(js_k), t(js_v)), j8.stack_scales(js_k, js_v)),
        (pkv.combine_kv(t(k), t(v)), jkv.combine_kv(*_j(k, v))),
        (pln.combine_kv_lanes(t(k), t(v)), jln.combine_kv_lanes(*_j(k, v))),
        (pln.step_row_lanes(t(k[0, :, :, :1]), t(v[0, :, :, :1])),
         jln.step_row_lanes(*_j(k[0, :, :, :1], v[0, :, :, :1]))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), np.asarray(want))
    # the lane rows are H-major [K_h | V_h], not a transposed view
    rows = pln.combine_kv_lanes(t(k), t(v))
    assert torch.equal(rows[0, 0, 5, 2 * DH:3 * DH], t(k[0, 0, 1, 5]))
    assert torch.equal(rows[0, 0, 5, 3 * DH:4 * DH], t(v[0, 0, 1, 5]))


def test_int8_prefill_cache_conversion_bit_equal_jax():
    """JAX's prefill cache (the tail past the prefix is zero) converted by
    JAX and by the port: equal int8 values and scales, 1e-8 on zero
    rows."""
    from torch_port_helpers import make_pair

    jcfg, params, _ = make_pair()
    rng = np.random.RandomState(4)
    Tp, cache_len = 20, I.cache_rows(20 + 40, "int8", jcfg.nhead)
    xy = rng.randn(2, Tp, jcfg.d_model).astype(np.float32)
    bias = np.zeros((2, 1, Tp, Tp), np.float32)
    _, cache = jtfm.encoder_stack_prefill(
        params["ar"]["decoder"], jnp.asarray(xy), jnp.asarray(bias),
        nhead=jcfg.nhead, cache_len=cache_len)
    kq, ks = jtfm.quantize_kv(cache["k"])
    vq, vs = jtfm.quantize_kv(cache["v"])
    got = I.convert_cache({n: t(cache[n]) for n in ("k", "v")}, "int8")
    assert cache_len == 256
    assert np.array_equal(got["kv"].numpy(),
                          np.asarray(j8.combine_kv_int8(kq, vq)))
    assert np.array_equal(got["scale"].numpy(),
                          np.asarray(j8.stack_scales(ks, vs)))
    assert (got["scale"][..., Tp:] == np.float32(1e-8)).all()


def test_resolve_decode_mode_follows_jax_rule():
    """At B % 8 != 0 the JAX package runs its grouped modes on the exact
    path and its fused kernel modes as "fused" (valle_tpu/models
    /inference.py:159-164, 761-771); at B = 8 every mode runs as named;
    "auto" takes int8 at B % 8 == 0 once the cache reaches 640."""
    from valle_tpu.models.inference import (
        resolve_auto_decode_mode as jax_auto)

    cfg = ValleConfig(d_model=128, nhead=4, num_layers=1)
    sub = {"int8": "exact", "bf16": "exact", "lanes": "exact",
           "fused_int8": "fused", "fused_kv": "fused",
           "fused_lanes": "fused", "mega": "fused"}
    for mode in I.DECODE_MODES:
        kw = dict(S=16, P=32, max_gen_len=64)
        assert I.resolve_decode_mode(mode, cfg, B=4, **kw) == sub.get(
            mode, mode)
        assert I.resolve_decode_mode(mode, cfg, B=8, **kw) == mode
        resolved = I.resolve_decode_mode(mode, cfg, B=12, **kw)
        assert I.resolve_decode_mode(resolved, cfg, B=12, **kw) == resolved
    for B_, gen in ((8, 600), (8, 500), (16, 700), (4, 700), (12, 700)):
        want = jax_auto(B=B_, S=16, P=32, max_gen_len=gen)
        got = I.resolve_decode_mode("auto", cfg, B=B_, S=16, P=32,
                                    max_gen_len=gen)
        assert got == sub.get(want, want) if B_ % 8 else got == want
    assert I.resolve_decode_mode("auto", cfg, B=8, S=16, P=32,
                                 max_gen_len=600) == "int8"
    # int8 wherever B3 takes the head dim (Dh 32, 64, 128), as JAX; at
    # another head dim "auto" picks fused, whose kernels (B1, B2) do not
    # depend on the head dim
    for d_model, nhead, want in ((256, 2, "int8"), (256, 8, "int8"),
                                 (384, 4, "fused")):
        c = ValleConfig(d_model=d_model, nhead=nhead, num_layers=1)
        assert I.resolve_decode_mode("auto", c, B=8, S=16, P=32,
                                     max_gen_len=600) == want
    with pytest.raises(ValueError, match="unknown decode mode"):
        I.resolve_decode_mode("lanes_grouped", cfg, B=8, S=16, P=32,
                              max_gen_len=64)
    narrow = ValleConfig(d_model=64, nhead=4, num_layers=1)
    with pytest.raises(ValueError, match="d_model % 128"):
        I.resolve_decode_mode("mega", narrow, B=8, S=16, P=32,
                              max_gen_len=64)


def test_cache_rounding_matches_jax():
    for mode, nhead, want in (("int8", 16, 768), ("fused_int8", 4, 768),
                              ("int8", 32, 640), ("bf16", 16, 640),
                              ("mega", 4, 640), ("lanes", 16, 640),
                              ("fused", 16, 600), ("exact", 4, 600)):
        assert I.cache_rows(600, mode, nhead) == want, (mode, nhead)
    assert min(j8.preferred_block(16), 256) == 256
    for h in (2, 4, 8, 16, 32):
        assert p8.preferred_block(h) == j8.preferred_block(h)


def test_wrappers_refuse_mixed_devices():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    kv = pkv.combine_kv(k, v).to("meta")
    with pytest.raises(RuntimeError, match="no kernel for devices"):
        pkv.decode_attention_kv(q, kv, t(X_LENS), t(WRITE_POS), S=S)
    with pytest.raises(RuntimeError, match="no kernel for devices"):
        pln.decode_attention_lanes(q.to("meta"), kv, t(X_LENS).to("meta"),
                                   t(WRITE_POS).to("meta"), S=S, nhead=H)
