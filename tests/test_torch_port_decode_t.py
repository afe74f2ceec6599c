"""The transposed-cache decode modes on the CPU: kernels B8
(``decode_attention``, mode ``per_sample``) and B9
(``decode_attention_grouped``, mode ``grouped``) of the port against the
JAX package's (fp32, its Pallas kernels in interpret mode, the port's plain
versions), the transposed cache bit for bit, the mode rule, and greedy
``valle_ar_decode`` codes against JAX's ``use_decode_kernel`` decode."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.modules import transformer as jtfm
from valle_tpu.ops.decode_attention import decode_attention as jax_b8
from valle_tpu.ops.decode_attention_grouped import (
    decode_attention_grouped as jax_b9)
from valle_tpu_torch.models import inference as I
from valle_tpu_torch.models.valle import ValleConfig
from valle_tpu_torch.ops import decode_attention as pb8
from valle_tpu_torch.ops import decode_attention_grouped as pb9

from torch_port_helpers import make_pair, slice_inputs, t
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

# the JAX package's oracle shapes (tests/test_attention.py:71-93, 132-140)
H, T, DH, S = 4, 512, 64, 40
X_LENS = np.array([40, 25, 10, 33, 7, 40, 18, 2], np.int32)
WRITE_POS = np.array([300, 120, 60, 440, 95, 511, 200, 47], np.int32)


def _case(B, seed=0, dh=DH):
    """q (B, H, 1, Dh) and the transposed caches (B, H, Dh, T)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, 1, dh).astype(np.float32)
    kt, vt = (rng.randn(B, H, dh, T).astype(np.float32) for _ in range(2))
    return q, kt, vt, X_LENS[:B], WRITE_POS[:B]


def test_per_sample_plain_matches_jax_kernel():
    args = _case(3)
    want = jax_b8(*(jnp.asarray(a) for a in args), S=S, block_k=128,
                  interpret=True)
    got = pb8.decode_attention(*(t(a) for a in args), S=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_grouped_plain_matches_jax_kernel():
    args = _case(8, seed=1)
    want = jax_b9(*(jnp.asarray(a) for a in args), S=S, interpret=True)
    got = pb9.decode_attention_grouped(*(t(a) for a in args), S=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    # each row's result is B8's: the grouping changes nothing per row
    assert torch.equal(got, pb8.decode_attention(*(t(a) for a in args),
                                                 S=S))
    # a scalar write position (aligned prompts) broadcasts over the rows
    q, kt, vt, xl, wp = (t(a) for a in args)
    assert torch.equal(
        pb9.decode_attention_grouped(q, kt, vt, xl, wp[3], S=S),
        pb8.decode_attention(q, kt, vt, xl, wp[3].expand(8), S=S))
    with pytest.raises(ValueError, match="multiple of the group"):
        pb9.decode_attention_grouped(*(x[:6] for x in (q, kt, vt, xl, wp)),
                                     S=S)


def test_transposed_plain_matches_jax_kernels_head_dim_128():
    """Dh 128 (the kernels take 32, 64 and 128): B8 and B9 plain against
    the JAX kernels in interpret mode."""
    args = _case(8, seed=2, dh=128)
    ja = [jnp.asarray(a) for a in args]
    pa = [t(a) for a in args]
    got = pb8.decode_attention(*pa, S=S)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_b8(*ja, S=S, block_k=128,
                                       interpret=True)), rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        pb9.decode_attention_grouped(*pa, S=S).numpy(),
        np.asarray(jax_b9(*ja, S=S, interpret=True)), rtol=0, atol=2e-6)
    assert 128 in pb8.TRANSPOSED_HEAD_DIMS


def test_transposed_cache_bit_equal_jax():
    """JAX's prefill cache (its tail past the prefix zero), transposed by
    JAX (``jnp.swapaxes``, valle_tpu/models/inference.py:233-236) and by
    the port's ``convert_cache``, at the cache length of each mode; and
    one decode step's column write."""
    jcfg, params, _ = make_pair(nhead=2)
    rng = np.random.RandomState(4)
    Tp = 20
    xy = rng.randn(2, Tp, jcfg.d_model).astype(np.float32)
    bias = np.zeros((2, 1, Tp, Tp), np.float32)
    for mode, rows in (("grouped", 128), ("per_sample", 256)):
        cache_len = I.cache_rows(Tp + 40, mode, jcfg.nhead)
        assert cache_len == rows
        _, cache = jtfm.encoder_stack_prefill(
            params["ar"]["decoder"], jnp.asarray(xy), jnp.asarray(bias),
            nhead=jcfg.nhead, cache_len=cache_len)
        got = I.convert_cache({n: t(cache[n]) for n in ("k", "v")}, mode)
        for n in ("k", "v"):
            want = np.asarray(jnp.swapaxes(cache[n], -2, -1))
            assert got[n].is_contiguous()
            assert np.array_equal(got[n].numpy(), want)
    # the step write: one column per row, as JAX's .at[bidx, :, :, pos]
    from valle_tpu_torch.modules.transformer import _write_step

    k, v = (rng.randn(2, 2, 1, 64).astype(np.float32) for _ in range(2))
    pos = np.array([21, 30])
    _write_step("t", got, 1, t(k), t(v), t(pos), torch.arange(2))
    ck = cache["k"].swapaxes(-2, -1)[1].at[jnp.arange(2), :, :, pos].set(
        jnp.asarray(k[:, :, 0]))
    assert np.array_equal(got["k"][1].numpy(), np.asarray(ck))


def test_mode_rule_and_entry_points():
    """"grouped" runs as "per_sample" at B % 8 != 0 (JAX :159-161); both
    belong to ``valle_ar_decode`` alone, as in the JAX package."""
    cfg = ValleConfig(d_model=128, nhead=4, num_layers=1)
    kw = dict(S=16, P=32, max_gen_len=64)
    assert I.resolve_decode_mode("grouped", cfg, B=6, **kw) == "per_sample"
    assert I.resolve_decode_mode("grouped", cfg, B=8, **kw) == "grouped"
    assert I.resolve_decode_mode("per_sample", cfg, B=8, **kw) == "per_sample"
    for mode in ("grouped", "per_sample"):
        with pytest.raises(ValueError, match="valle_inference"):
            I.valle_inference(None, None, None, None, None,
                              decode_mode=mode)
    assert I.cache_rows(600, "grouped", 16) == 640
    assert I.cache_rows(600, "per_sample", 16) == 768


@functools.lru_cache(maxsize=None)
def _jax_ar(mode, rows):
    from valle_tpu.models.inference import valle_ar_decode as jax_ar

    jcfg, params, _ = make_pair(nhead=2)
    x = slice_inputs(rows=rows)
    codes, lens = jax_ar(
        params, jcfg, jnp.asarray(x["text"]), jnp.asarray(x["text_lens"]),
        jnp.asarray(x["prompt_codes"][..., 0]),
        jnp.asarray(x["prompt_lens"]), jax.random.PRNGKey(0), top_k=1,
        max_gen_len=20, use_decode_kernel=True, kernel_interpret=True,
        decode_kernel_mode=mode)
    return np.asarray(codes), np.asarray(lens)


def _port_ar(mode, rows, **pair):
    _, _, model = make_pair(nhead=2, **pair)
    x = slice_inputs(rows=rows)
    codes, lens = I.valle_ar_decode(
        model, t(x["text"]), t(x["text_lens"]), t(x["prompt_codes"][..., 0]),
        t(x["prompt_lens"]), top_k=1, max_gen_len=20, decode_mode=mode)
    return codes.numpy(), lens.numpy()


@pytest.mark.parametrize("mode,rows", [("grouped", 8), ("per_sample", 3)])
def test_ar_decode_codes_equal_jax(mode, rows):
    """Greedy fp32, two heads of 64, 20 frames: the port's codes and
    lengths equal JAX's valle_ar_decode(use_decode_kernel=True) in the same
    mode, its kernel in interpret mode."""
    codes, lens = _port_ar(mode, rows)
    jcodes, jlens = _jax_ar(mode, rows)
    assert np.array_equal(lens, jlens)
    assert np.array_equal(codes, jcodes)


@pytest.mark.parametrize("prepend_bos", [False, True])
@pytest.mark.parametrize("prefix_mode", [0, 1, 2, 4])
def test_grouped_codes_equal_exact(prefix_mode, prepend_bos):
    """Across prefix modes and BOS, ``grouped`` gives the greedy codes of
    the port's own ``exact`` (which the slice tests hold against JAX)."""
    pair = dict(prefix_mode=prefix_mode, prepend_bos=prepend_bos)
    got = _port_ar("grouped", 8, **pair)
    want = _port_ar("exact", 8, **pair)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])
