"""The port's kernels on a CUDA device (marked ``cuda``; skipped without
one). This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.

Limits as chip_smoke.py states them: relative max-abs error vs the plain
version <= 1e-4 at fp32 (TF32 off), <= 2e-2 at bf16; dropout masks of the
kernels and the plain version agree bit for bit.
"""

import numpy as np
import pytest
import torch

from valle_tpu_torch.modules.transformer import quantize_kv
from valle_tpu_torch.ops import cuda_build as cb
from valle_tpu_torch.ops import decode_attention_int8_grouped as d8
from valle_tpu_torch.ops import decode_attention_kv as dkv
from valle_tpu_torch.ops import decode_attention_lanes as dln
from valle_tpu_torch.ops import fused_attn_tail as fat
from valle_tpu_torch.ops import fused_dense as fd
from valle_tpu_torch.ops import masks as M
from valle_tpu_torch.ops.flash_mha import (flash_mha_backward,
                                           flash_mha_forward, reference_mha,
                                           reference_mha_grads)
from valle_tpu_torch.ops.philox import dropout_bytes


@pytest.fixture
def cuda_device():
    """Skips where there is no CUDA device (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= limit * ref.float().abs().max().item(), err


def _randn(rng, *shape, scale=1.0, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)
                            ).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [3, 40])
def test_dense_kernels_match_plain(cuda_device, dtype, int8, B):
    rng = np.random.RandomState(B)
    D, F = 256, 1024
    r = lambda *s, scale=1.0: _randn(rng, *s, scale=scale,  # noqa: E731
                                     dev=cuda_device)
    h, a = r(B, D).to(dtype), r(B, D).to(dtype)
    ln_w, ln_b = 1 + r(D, scale=0.1), r(D, scale=0.1)
    w = {n: r(*shape, scale=shape[1] ** -0.5).to(dtype)
         for n, shape in (("in", (3 * D, D)), ("out", (D, D)),
                          ("w1", (F, D)), ("w2", (D, F)))}
    sc = {}
    if int8:
        for n in w:
            w[n], sc[n] = fd.quantize_weights_per_channel(w[n])
    qkv = (h, ln_w, ln_b, w["in"], r(3 * D, scale=0.1))
    _close(fd.fused_ln_qkv(*qkv, w_scale=sc.get("in")),
           fd.fused_ln_qkv_plain(*qkv, w_scale=sc.get("in")), dtype)
    args = (a, h, w["out"], r(D, scale=0.1), ln_w, ln_b, w["w1"],
            r(F, scale=0.1), w["w2"], r(D, scale=0.1))
    scales = (sc["out"], sc["w1"], sc["w2"]) if int8 else None
    for act in ("relu", "gelu"):
        _close(fd.fused_tail(*args, activation=act, w_scales=scales),
               fd.fused_tail_plain(*args, activation=act, w_scales=scales),
               dtype)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [70, 200])
def test_flash_kernel_matches_plain(cuda_device, dtype, S):
    rng = np.random.RandomState(S)
    B, H, D = 2, 3, 64
    q, k, v = (_randn(rng, B, H, S, D, dev=cuda_device).to(dtype)
               for _ in range(3))
    lens = torch.tensor([S, S // 2 + 1], device=cuda_device)
    kv = torch.arange(S, device=cuda_device)[None] < lens[:, None]
    qc, kc = M.flash_codes_key_valid(kv)
    out, lse = flash_mha_forward(q, k, v, qc, kc)
    ref, ref_lse = reference_mha(q, k, v, qc, kc, return_lse=True)
    _close(out, ref, dtype)
    _close(lse, ref_lse, torch.float32)
    # packed rows: segments + the always-visible diagonal
    seg = torch.arange(S, device=cuda_device).div(17, rounding_mode="floor")
    seg = seg.to(torch.int32).expand(B, S).contiguous()
    zero = torch.zeros_like(seg)
    out = flash_mha_forward(q, k, v, zero, zero, qseg=seg, kseg=seg,
                            add_diag=True)[0]
    _close(out, reference_mha(q, k, v, zero, zero, qseg=seg, kseg=seg,
                              add_diag=True), dtype)
    torch.cuda.synchronize()


def _decode_case(rng, B, H, Dh, T, S, dtype, dev):
    """q, k, v and spread lengths: x_len in [1, S], write_pos in [S, T),
    row 0 reading the whole cache and row 1 only its first audio key."""
    q, k, v = (_randn(rng, B, H, n, Dh, dev=dev).to(dtype)
               for n in (1, T, T))
    x_lens = torch.from_numpy(rng.randint(1, S + 1, B)).to(dev)
    wp = torch.from_numpy(rng.randint(S, T, B)).to(dev)
    x_lens[0], wp[0], wp[1] = S, T - 1, S
    return q, k, v, x_lens, wp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Dh", [(8, 4, 64), (5, 16, 64), (3, 2, 32)])
def test_decode_attention_kernels_match_plain(cuda_device, dtype, B, H, Dh):
    """B3 (int8), B10 (kv) and B11 (lanes) against their plain versions,
    at any batch size and with a scalar write_pos (aligned prompts)."""
    rng = np.random.RandomState(B * H)
    T, S = 384, 40
    q, k, v, x_lens, wp = _decode_case(rng, B, H, Dh, T, S, dtype,
                                       cuda_device)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    i8 = (d8.combine_kv_int8(kq, vq), d8.stack_scales(ks, vs))
    kv, lanes = dkv.combine_kv(k, v), dln.combine_kv_lanes(k, v)
    for w in (wp, wp[2]):
        _close(d8.decode_attention_int8_grouped(q, *i8, x_lens, w, S=S),
               d8.decode_attention_int8_grouped_plain(q, *i8, x_lens, w,
                                                      S=S), dtype)
        _close(dkv.decode_attention_kv(q, kv, x_lens, w, S=S),
               dkv.decode_attention_kv_plain(q, kv, x_lens, w, S=S), dtype)
        _close(dln.decode_attention_lanes(q, lanes, x_lens, w, S=S,
                                          nhead=H),
               dln.decode_attention_lanes_plain(q, lanes, x_lens, w, S=S,
                                                nhead=H), dtype)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_attn_tail_kernel_matches_plain(cuda_device, dtype,
                                              activation):
    rng = np.random.RandomState(7)
    B, H, Dh, T, S, F = 8, 4, 64, 256, 40, 1024
    D = H * Dh
    q, k, v, x_lens, wp = _decode_case(rng, B, H, Dh, T, S, dtype,
                                       cuda_device)
    r = lambda *s, scale=1.0: _randn(rng, *s, scale=scale,  # noqa: E731
                                     dev=cuda_device)
    args = (q, r(B, D).to(dtype), dln.combine_kv_lanes(k, v), x_lens, wp,
            r(D, D, scale=D ** -0.5).to(dtype), r(D, scale=0.1),
            1 + r(D, scale=0.1), r(D, scale=0.1),
            r(F, D, scale=D ** -0.5).to(dtype), r(F, scale=0.1),
            r(D, F, scale=F ** -0.5).to(dtype), r(D, scale=0.1))
    _close(fat.fused_attn_tail(*args, S=S, activation=activation),
           fat.fused_attn_tail_plain(*args, S=S, activation=activation),
           dtype)
    torch.cuda.synchronize()


def _train_codes(kind, B, S, dev):
    """AR composite (text 24, then causal audio) or packed rows; no row
    is fully masked."""
    if kind == "ar":
        lens = torch.tensor([S, S // 2 + 30], device=dev)
        return M.flash_codes_ar_xy(torch.tensor([24, 13], device=dev),
                                   lens - 24, 24, S - 24), {}
    seg = torch.arange(S, device=dev).div(17, rounding_mode="floor")
    seg = seg.to(torch.int32).expand(B, S).contiguous()
    zero = torch.zeros_like(seg)
    return (zero, zero), dict(qseg=seg, kseg=seg, add_diag=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind,S", [("ar", 70), ("ar", 200),
                                    ("packed", 131)])
def test_flash_backward_matches_plain(cuda_device, dtype, rate, kind, S):
    """Forward and backward kernels against the plain version (autograd
    through reference_mha) with the same Philox bytes; the in-kernel
    Philox and the plain bytes handed in as bits give bit-equal results,
    so the masks agree bit for bit."""
    rng = np.random.RandomState(S)
    B, H, D = 2, 3, 64
    q, k, v, g = (_randn(rng, B, H, S, D, dev=cuda_device).to(dtype)
                  for _ in range(4))
    (qc, kc), extra = _train_codes(kind, B, S, cuda_device)
    kw = dict(extra, dropout_rate=rate, seed=1234 if rate else None)
    out, lse = flash_mha_forward(q, k, v, qc, kc, **kw)
    grads = flash_mha_backward(q, k, v, qc, kc, out, lse, g, **kw)
    ref, ref_lse = reference_mha(q, k, v, qc, kc, return_lse=True, **kw)
    _close(out, ref, dtype)
    _close(lse, ref_lse, torch.float32)
    for got, want in zip(grads, reference_mha_grads(q, k, v, qc, kc, g,
                                                    **kw)):
        _close(got, want, dtype)
    if rate:
        kw_bits = dict(extra, dropout_rate=rate,
                       bits=dropout_bytes(1234, B, H, S, S,
                                          device=cuda_device))
        out_b, lse_b = flash_mha_forward(q, k, v, qc, kc, **kw_bits)
        assert torch.equal(out_b, out)
        grads_b = flash_mha_backward(q, k, v, qc, kc, out_b, lse_b, g,
                                     **kw_bits)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads_b))
    torch.cuda.synchronize()


MODE_KERNELS = {
    "fused": ("fused_ln_qkv", "fused_tail"),
    "int8": ("decode_attention_int8_grouped",),
    "fused_int8": ("fused_ln_qkv", "decode_attention_int8_grouped",
                   "fused_tail"),
    "bf16": ("decode_attention_kv",),
    "fused_kv": ("fused_ln_qkv", "decode_attention_kv", "fused_tail"),
    "lanes": ("decode_attention_lanes",),
    "fused_lanes": ("fused_ln_qkv", "decode_attention_lanes", "fused_tail"),
    "mega": ("fused_ln_qkv", "fused_attn_tail"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODE_KERNELS))
def test_synthesize_on_cuda_goes_through_every_kernel(cuda_device, mode):
    """Eight requests (the JAX package's grouped modes need B % 8 == 0)
    through each kernel mode: its kernels and the NAR flash kernel
    launch."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.serving import SynthesisRequest, Synthesizer

    gen = torch.Generator(cuda_device).manual_seed(0)
    model = VALLE(ValleConfig(d_model=256, nhead=4, num_layers=2,
                              num_quantizers=8, max_len=512),
                  generator=gen).eval()
    synth = Synthesizer(model, TextTokenizer(backend="char"),
                        TextTokenCollater(list("abcdefghijklmnopqrstuvwxyz_")),
                        AudioTokenizer(device=cuda_device), top_k=5,
                        decode_mode=mode, device=cuda_device)
    rng = np.random.RandomState(0)
    reqs = [SynthesisRequest(text=t, prompt_codes=rng.randint(0, 1024,
                                                              (9 + i, 8)))
            for i, t in enumerate(("hello world", "another request", "short",
                                   "a b c", "four", "five requests",
                                   "six", "the last one"))]
    cb.reset_launch_counts()
    out = synth.synthesize(reqs, max_gen_len=16)
    torch.cuda.synchronize()
    assert synth.last_decode_mode == mode
    launched = MODE_KERNELS[mode] + ("flash_mha_fwd",)
    assert all(cb.LAUNCHES[n] > 0 for n in launched), cb.LAUNCHES
    for res in out:
        assert res.wav.shape == (res.frames * 320,)
        assert np.isfinite(res.wav).all()
