"""Port modules vs the JAX package, function by function, at fp32 (1e-5;
the codec at atol 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.codec.model import EncodecConfig as JaxEncodecConfig
from valle_tpu.codec.model import encodec_decode as jax_encodec_decode
from valle_tpu.codec.model import init_encodec
from valle_tpu.models.inference import trim_enrolled_text as jax_trim
from valle_tpu.modules import embedding as jemb
from valle_tpu.modules import transformer as jtfm
from valle_tpu.ops import masks as JM
from valle_tpu.ops.sampling import top_k_top_p_filtering as jax_filter
from valle_tpu_torch.codec.model import EncodecModel, encodec_decode
from valle_tpu_torch.models.inference import trim_enrolled_text
from valle_tpu_torch.modules import embedding as emb
from valle_tpu_torch.modules import transformer as tfm
from valle_tpu_torch.ops import masks as M
from valle_tpu_torch.ops.sampling import top_k_top_p_filtering
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict)

from torch_port_helpers import make_pair, t
from torch_port_helpers import jit_init
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(a, b, **tol):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


def test_embedding_and_positions_with_alpha():
    rng = np.random.RandomState(0)
    w = rng.randn(50, 64).astype(np.float32)
    ids = rng.randint(0, 50, (2, 9))
    alpha = np.array([0.7], np.float32)
    jtab = jemb.sine_positional_table(128, 64)
    ref = jemb.apply_sine_positional(
        {"alpha": jnp.asarray(alpha)},
        jemb.token_embedding({"weight": jnp.asarray(w)}, jnp.asarray(ids)),
        jtab, offset=5)
    tab = emb.sine_positional_table(128, 64)
    _close(tab, jtab)
    out = emb.apply_sine_positional(
        t(alpha), emb.token_embedding(t(w), t(ids)), tab, offset=5)
    _close(out, ref)


def test_masks_match_jax():
    x_lens, y_lens = np.array([5, 9]), np.array([7, 3])
    _close(M.ar_xy_attn_bias(t(x_lens), t(y_lens), 10, 8),
           JM.ar_xy_attn_bias(jnp.asarray(x_lens), jnp.asarray(y_lens),
                              10, 8), rtol=0, atol=0)
    _close(M.key_padding_bias(t(x_lens), 10),
           JM.key_padding_bias(jnp.asarray(x_lens), 10), rtol=0, atol=0)
    kv = np.arange(12)[None] < np.array([[4], [12]])
    for a, b in zip(M.flash_codes_key_valid(t(kv)),
                    JM.flash_codes_key_valid(jnp.asarray(kv))):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (5, 1.0), (-100, 1.0),
                                         (-100, 0.9), (10, 0.8)])
def test_top_k_top_p_filtering_matches_jax(top_k, top_p):
    logits = np.random.RandomState(1).randn(3, 300).astype(np.float32)
    logits[0, :4] = logits[0, 4]        # ties at the k-th value
    ref = np.asarray(jax_filter(jnp.asarray(logits), top_k=top_k,
                                top_p=top_p))
    out = top_k_top_p_filtering(t(logits), top_k=top_k, top_p=top_p).numpy()
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    _close(out[~np.isinf(out)], ref[~np.isinf(ref)])


def _ar_inputs(d, seed=2):
    rng = np.random.RandomState(seed)
    B, S, P = 2, 6, 10
    x = rng.randn(B, S + P, d).astype(np.float32)
    x_lens, p_lens = np.array([6, 4]), np.array([10, 7])
    return x, x_lens, p_lens, S, P


def test_prefill_and_decode_step_match_jax():
    jcfg, params, model = make_pair()
    d = jcfg.d_model
    x, x_lens, p_lens, S, P = _ar_inputs(d)
    cache_len = S + P + 4
    jbias = JM.ar_xy_attn_bias(jnp.asarray(x_lens), jnp.asarray(p_lens), S, P)
    jdec = params["ar"]["decoder"]
    jh, jcache = jtfm.encoder_stack_prefill(
        jdec, jnp.asarray(x), jbias, nhead=jcfg.nhead, cache_len=cache_len)
    bias = M.ar_xy_attn_bias(t(x_lens), t(p_lens), S, P)
    h, cache = tfm.encoder_stack_prefill(model.ar_decoder, t(x), bias,
                                         cache_len=cache_len)
    _close(h, jh)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])

    # one decode step at per-sample write positions
    step = np.random.RandomState(3).randn(2, 1, d).astype(np.float32)
    pos = S + p_lens
    kk = np.arange(cache_len)[None]
    valid = (kk < x_lens[:, None]) | ((kk >= S) & (kk <= pos[:, None]))
    sbias = np.where(valid, 0.0, -np.inf).astype(np.float32)[:, None, None]
    jh2, jc2 = jtfm.encoder_stack_decode_step(
        jdec, jnp.asarray(step), jcache, jnp.asarray(pos), jnp.asarray(sbias),
        nhead=jcfg.nhead)
    for mode in ("exact", "fused"):
        c = {n: v.clone() for n, v in cache.items()}
        h2 = tfm.encoder_stack_decode_step(
            model.ar_decoder, t(step), c, t(pos), t(sbias), mode=mode)
        _close(h2, jh2)
        _close(c["k"], jc2["k"])
        _close(c["v"], jc2["v"])


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_nar_stack_with_adaln_matches_jax(attn):
    jcfg, params, model = make_pair()
    rng = np.random.RandomState(4)
    B, T, d = 2, 40, jcfg.d_model
    x = rng.randn(B, T, d).astype(np.float32)
    kv = np.arange(T)[None] < np.array([[40], [29]])
    stage = 3
    jcond = params["nar"]["stage_embs"]["weight"][stage][None]
    if attn == "flash":
        qc, kc = JM.flash_codes_key_valid(jnp.asarray(kv))
        jkw = {"flash_spec": {"qcode": qc, "kcode": kc}}
        pqc, pkc = M.flash_codes_key_valid(t(kv))
        kw = {"flash_spec": {"qcode": pqc, "kcode": pkc}}
        jbias = bias = None
    else:
        jkw, kw = {}, {}
        jbias = jnp.where(jnp.asarray(kv), 0.0, -jnp.inf)[:, None, None]
        bias = t(np.asarray(jbias))
    ref = jtfm.encoder_stack_apply(params["nar"]["decoder"], jnp.asarray(x),
                                   jbias, jcond, nhead=jcfg.nar_nhead, **jkw)
    cond = model.nar_stage_embeddings[stage].word_embeddings.weight
    out = tfm.encoder_stack_apply(model.nar_decoder, t(x), bias, cond, **kw)
    _close(out, ref)


def test_trim_enrolled_text_matches_jax():
    text = np.arange(24).reshape(2, 12)
    lens, enroll = np.array([12, 9]), np.array([5, 2])
    a, al = trim_enrolled_text(t(text), t(lens), t(enroll))
    b, bl = jax_trim(jnp.asarray(text), jnp.asarray(lens),
                     jnp.asarray(enroll))
    assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(al.numpy(), np.asarray(bl))


def test_encodec_decode_matches_jax_on_10_frames():
    cfg = JaxEncodecConfig()
    params = jit_init(init_encodec, 0, cfg)
    codec = EncodecModel()
    load_numpy_state_dict(codec, encodec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    codes = np.random.RandomState(5).randint(0, 1024, (2, 10, 8))
    ref = jax_encodec_decode(params, jnp.asarray(codes), cfg=cfg)
    out = encodec_decode(codec, t(codes))
    assert out.shape == (2, 10 * 320, 1)
    _close(out, ref, rtol=0, atol=1e-4)
