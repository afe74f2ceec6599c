"""The port's kernels on a CUDA device (marked ``cuda``; skipped without
one). This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.

Limits as chip_smoke.py states them: relative max-abs error vs the plain
version <= 1e-4 at fp32 (TF32 off), <= 2e-2 at bf16; dropout masks of the
kernels and the plain version agree bit for bit. The attention kernels B6-B9
are held at fp32 to an absolute 2e-5 (JAX's tolerance for them).
"""

import copy

import numpy as np
import pytest
import torch

from valle_tpu_torch.modules.transformer import quantize_kv
from valle_tpu_torch.ops import attention as pa
from valle_tpu_torch.ops import cuda_build as cb
from valle_tpu_torch.ops import decode_attention as dt8
from valle_tpu_torch.ops import decode_attention_grouped as dt9
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


def _close_attn(got, ref, dtype):
    """B6-B9: fp32 within 2e-5 absolute; bf16 as _close (2e-2 of the
    largest entry: the bf16 kernels round p to bf16 before P.V)."""
    if dtype != torch.float32:
        return _close(got, ref, dtype)
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-5, err


def _randn(rng, *shape, scale=1.0, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)
                            ).to(dev)


def _dense_case(dev, dtype, int8, B, D, F):
    """fused_ln_qkv and fused_tail arguments: (qkv args, tail args, scales
    of in_w, tail scales). LayerNorm and bias parameters in fp32. The D
    256 cases keep the seed they had before other widths were added."""
    rng = np.random.RandomState(B if D == 256 else B + D)
    r = lambda *s, scale=1.0: _randn(rng, *s, scale=scale,  # noqa: E731
                                     dev=dev)
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
    tail = (a, h, w["out"], r(D, scale=0.1), ln_w, ln_b, w["w1"],
            r(F, scale=0.1), w["w2"], r(D, scale=0.1))
    return qkv, tail, sc.get("in"), ((sc["out"], sc["w1"], sc["w2"])
                                     if int8 else None)


def _check_dense(dev, dtype, int8, B, D, F):
    qkv, tail, s_in, scales = _dense_case(dev, dtype, int8, B, D, F)
    _close(fd.fused_ln_qkv(*qkv, w_scale=s_in),
           fd.fused_ln_qkv_plain(*qkv, w_scale=s_in), dtype)
    for act in ("relu", "gelu"):
        _close(fd.fused_tail(*tail, activation=act, w_scales=scales),
               fd.fused_tail_plain(*tail, activation=act, w_scales=scales),
               dtype)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [3, 40, 1, 8, 32, 64, 65, 200])
def test_dense_kernels_match_plain(cuda_device, dtype, int8, B):
    """D 256 / F 1024; B past 64 loops over row passes (65: one row in
    the second), B 200 four passes."""
    _check_dense(cuda_device, dtype, int8, B, 256, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_kernels_match_plain_full_width(cuda_device, dtype, int8):
    """The decode shape: B 32, D 1024, F 4096 (lin2's K split over a
    cluster of 8)."""
    _check_dense(cuda_device, dtype, int8, 32, 1024, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D,F", [(640, 2560), (896, 3584), (1152, 4608),
                                 (1280, 5120), (256, 8704)])
@pytest.mark.parametrize("B", [3, 65])
def test_dense_kernels_take_every_width(cuda_device, int8, D, F, B):
    """Widths whose 64-wide k tiles do not split evenly over a cluster
    (d 640: 10 tiles, 1152: 18, 1280: 20 with LayerNorm), and F 8704 (136
    tiles: lin2's blocks own 8 or 9, so some take their slice in two
    chunks)."""
    _check_dense(cuda_device, torch.bfloat16, int8, B, D, F)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("B", [3, 65])
def test_dense_kernel_takes_a_slice_in_chunks(cuda_device, int8, ln, B):
    """K 8704 into 128 columns: a cluster of 16 blocks, 8 or 9 k tiles
    each, so some take their slice in two chunks (with LayerNorm, its
    statistics first read from device memory); B 65 reloads the weights
    for the second row pass."""
    rng = np.random.RandomState(B)
    K, N, bf = 8704, 128, torch.bfloat16
    r = lambda *s, scale=1.0: _randn(rng, *s, scale=scale,  # noqa: E731
                                     dev=cuda_device)
    x, w, b = r(B, K).to(bf), r(N, K, scale=K ** -0.5).to(bf), r(N, scale=0.1)
    ln_w, ln_b = 1 + r(K, scale=0.1), r(K, scale=0.1)
    scale = None
    if int8:
        w, scale = fd.quantize_weights_per_channel(w)
    got = fd._dense("dense", x, w, scale, b, epi=fd._EPI_BIAS,
                    ln=(ln_w, ln_b, 1e-5) if ln else None)
    xin = fd._layer_norm_rows(x, ln_w, ln_b) if ln else x
    _close(got, fd._mms(xin, w, scale) + b.to(bf), bf)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [32, 65])
def test_dense_kernels_bit_equal_across_launches(cuda_device, int8, B):
    """The split-K partials are summed in a fixed order: two launches
    give the same bits."""
    qkv, tail, s_in, scales = _dense_case(cuda_device, torch.bfloat16,
                                          int8, B, 1024, 4096)
    for _ in range(2):
        a = fd.fused_ln_qkv(*qkv, w_scale=s_in)
        b = fd.fused_ln_qkv(*qkv, w_scale=s_in)
        assert torch.equal(a, b)
        a = fd.fused_tail(*tail, w_scales=scales)
        b = fd.fused_tail(*tail, w_scales=scales)
        assert torch.equal(a, b)
    torch.cuda.synchronize()


def _device_kernels(fn, path):
    """Names of the kernels one fn() launches, from a torch.profiler trace
    written to ``path``. A trace can miss the kernels of its first
    milliseconds: fn runs for 50 ms first, and only the kernels between
    two marker kernels around the counted call are kept."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm_until = time.perf_counter() + 0.05
        while time.perf_counter() < warm_until:
            fn()
            torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("cat") == "kernel"]
    marks = sorted(e["ts"] for e in events if "spin_kernel" in e["name"])
    assert len(marks) >= 2, "the trace lost its marker kernels"
    return [e["name"] for e in events if marks[-2] < e["ts"] < marks[-1]
            and "spin_kernel" not in e["name"]]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_dense_calls_launch_one_and_three_kernels(cuda_device, int8,
                                                  tmp_path):
    """bf16: fused_ln_qkv is one kernel (LayerNorm in its prologue),
    fused_tail three (LN2 in lin1's prologue). Parameters in bf16, so no
    conversion kernel runs."""
    qkv, tail, s_in, scales = _dense_case(cuda_device, torch.bfloat16,
                                          int8, 32, 1024, 4096)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    qkv = (qkv[0], bf(qkv[1]), bf(qkv[2]), qkv[3], bf(qkv[4]))
    tail = tuple(x if x.dim() == 2 else bf(x) for x in tail)
    k = _device_kernels(lambda: fd.fused_ln_qkv(*qkv, w_scale=s_in),
                        tmp_path / "qkv.json")
    assert len(k) == 1 and "dense_wgmma" in k[0], k
    k = _device_kernels(lambda: fd.fused_tail(*tail, w_scales=scales),
                        tmp_path / "tail.json")
    assert len(k) == 3 and all("dense_wgmma" in n for n in k), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [70, 200])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_matches_plain(cuda_device, dtype, S, D):
    rng = np.random.RandomState(S)
    B, H = 2, 3
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
@pytest.mark.parametrize("B,H,Dh", [(8, 4, 64), (5, 16, 64), (3, 2, 32),
                                    (8, 2, 128), (5, 8, 128)])
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


def _int8_cache(k, v):
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return d8.combine_kv_int8(kq, vq), d8.stack_scales(ks, vs)


# B3's edge cases, (B, T, S), and the bench step's batch and cache
INT8_EDGES = {"x_len_0": (5, 384, 40), "whole_cache": (4, 384, 40),
              "ragged_ends": (6, 1024, 61), "one_row": (1, 512, 64),
              "long_cache": (3, 2048, 64), "bench_step": (32, 512, 64)}


def _int8_edge_lengths(case, rng, B, T, S, dev):
    """x_len in [0, S], write_pos in [S, T), then the case's own rows."""
    x_lens, wp = rng.randint(0, S + 1, B), rng.randint(S, T, B)
    if case == "x_len_0":            # no text key; row 0 one audio key
        x_lens[:] = 0
        wp[0], wp[1] = S, T - 1
    elif case == "whole_cache":      # every key of the cache
        x_lens[:], wp[:] = S, T - 1
    elif case == "ragged_ends":      # runs ending off 4 keys and 128
        x_lens[:3], wp[:3] = (S, 1, 7), (T - 2, S + 130, S + 253)
    elif case == "one_row":
        x_lens[0], wp[0] = 37, S + 300
    return (torch.from_numpy(x).to(dev) for x in (x_lens, wp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Dh", [(16, 64), (8, 128), (4, 32)])
@pytest.mark.parametrize("case", list(INT8_EDGES))
def test_int8_decode_kernel_edges(cuda_device, dtype, H, Dh, case):
    """B3's bulk-copied chunks at the edges of its two key runs: no text
    key (x_len 0; a row whose only key is its first audio key), the whole
    cache (x_len = S, write_pos = T - 1), runs ending off multiples of 4
    keys and of the 128-key chunk (S 61), one row, a cache of 16 chunks,
    and the bench step's batch and cache (B 32, 512 rows); per-row and
    scalar write_pos; two launches give the same bits (the sums run in a
    fixed order, with no atomics)."""
    B, T, S = INT8_EDGES[case]
    rng = np.random.RandomState(B * T + Dh)
    q, k, v = (_randn(rng, B, H, n, Dh, dev=cuda_device).to(dtype)
               for n in (1, T, T))
    x_lens, wp = _int8_edge_lengths(case, rng, B, T, S, cuda_device)
    i8 = _int8_cache(k, v)
    for w in (wp, wp[0]):
        got = d8.decode_attention_int8_grouped(q, *i8, x_lens, w, S=S)
        _close(got, d8.decode_attention_int8_grouped_plain(q, *i8, x_lens, w,
                                                           S=S), dtype)
        assert torch.equal(got, d8.decode_attention_int8_grouped(
            q, *i8, x_lens, w, S=S))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels_launch_on_every_card(cuda_device):
    """Function attributes and SM counts belong to a device, so the dense
    kernels (B1/B2, bf16 and int8 weights) and B3 must launch and match
    their plain versions on every card a process uses, each after the
    first (with one card, on that card alone)."""
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            for int8 in (False, True):
                _check_dense(dev, torch.bfloat16, int8, 32, 256, 1024)
            rng = np.random.RandomState(i)
            q, k, v, x_lens, wp = _decode_case(rng, 4, 2, 64, 384, 40,
                                               torch.bfloat16, dev)
            i8 = _int8_cache(k, v)
            _close(d8.decode_attention_int8_grouped(q, *i8, x_lens, wp,
                                                    S=40),
                   d8.decode_attention_int8_grouped_plain(q, *i8, x_lens,
                                                          wp, S=40),
                   torch.bfloat16)
            torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("H,Dh", [(4, 64), (2, 128)])
def test_fused_attn_tail_kernel_matches_plain(cuda_device, dtype,
                                              activation, H, Dh):
    rng = np.random.RandomState(7)
    B, T, S, F = 8, 256, 40, 1024
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
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_matches_plain(cuda_device, dtype, rate, kind, S, D):
    """Forward and backward kernels against the plain version (autograd
    through reference_mha) with the same Philox bytes; the in-kernel
    Philox and the plain bytes handed in as bits give bit-equal results,
    so the masks agree bit for bit. Dh 64 and 128."""
    rng = np.random.RandomState(S)
    B, H = 2, 3
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


def _edge_codes(case, B, dev):
    """(S, T, qcode, kcode, extra kwargs, row that sees no key or None)
    for the tile-skipping and ragged-edge cases of the training kernels."""
    from valle_tpu_torch.ops.flash_mha import CODE_INVALID

    if case in ("s70_t200", "s200_t70"):
        S, T = (70, 200) if case == "s70_t200" else (200, 70)
        # a causal rule scaled to S != T; batch row 1 pads half its keys
        qc = (torch.arange(S, device=dev) * T // S).to(torch.int32)
        kc = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
        kc[1, T // 2:] = CODE_INVALID
        return S, T, qc.expand(B, S).contiguous(), kc, {}, None
    S = T = 200
    if case == "packed_17":
        seg = torch.arange(S, device=dev).div(17, rounding_mode="floor")
        seg = seg.to(torch.int32).expand(B, S).contiguous()
        zero = torch.zeros_like(seg)
        return S, T, zero, zero, dict(qseg=seg, kseg=seg,
                                      add_diag=True), None
    # AR composite codes, batch row 1 padded to 100 positions: whole key
    # tiles are padding, and the causal rule hides the tiles above the
    # diagonal
    qc, kc = M.flash_codes_ar_xy(torch.tensor([24, 13], device=dev),
                                 torch.tensor([176, 87], device=dev), 24,
                                 176)
    if case == "ar_padded":
        return S, T, qc, kc, {}, None
    qc = qc.clone()
    qc[0, 5] = -1          # query 5 of batch row 0 sees no key
    return S, T, qc, kc, {}, 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", ["s70_t200", "s200_t70", "ar_padded",
                                  "packed_17", "unseen_row"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_skip_tiles_and_ragged_edges(cuda_device, dtype, rate,
                                                   case, D):
    """Forward and backward against the plain versions where the kernels
    skip whole tiles, at S != T, and with one query that sees no key among
    queries that do (the forward averages all T keys; the backward is
    compared with that row's cotangent zero, its documented contract);
    the in-kernel Philox equals the plain bytes handed in, and two
    launches give the same bits."""
    rng = np.random.RandomState(11)
    B, H = 2, 3
    S, T, qc, kc, extra, unseen = _edge_codes(case, B, cuda_device)
    q, g = (_randn(rng, B, H, S, D, dev=cuda_device).to(dtype)
            for _ in range(2))
    k, v = (_randn(rng, B, H, T, D, dev=cuda_device).to(dtype)
            for _ in range(2))
    if unseen is not None:
        g[0, :, unseen] = 0
    kw = dict(extra, dropout_rate=rate, seed=77 if rate else None)
    out, lse = flash_mha_forward(q, k, v, qc, kc, **kw)
    ref, ref_lse = reference_mha(q, k, v, qc, kc, return_lse=True, **kw)
    _close(out, ref, dtype)
    seen = torch.ones_like(lse, dtype=torch.bool)
    if unseen is not None:
        seen[0, :, unseen] = False
        assert (lse[~seen] <= -1e29).all()
    _close(lse[seen], ref_lse[seen], torch.float32)
    grads = flash_mha_backward(q, k, v, qc, kc, out, lse, g, **kw)
    for got, want in zip(grads, reference_mha_grads(q, k, v, qc, kc, g,
                                                    **kw)):
        _close(got, want, dtype)
    again = flash_mha_backward(q, k, v, qc, kc, out, lse, g, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    if rate:
        kw_bits = dict(extra, dropout_rate=rate,
                       bits=dropout_bytes(77, B, H, S, T,
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fused_kv", "fused_lanes", "mega",
                                  "auto"])
def test_head_dim_128_modes_go_through_their_kernels(cuda_device, mode):
    """d_model 256 with 2 heads (Dh 128): the decode kernels take it,
    "auto" picks int8 at a long cache (as JAX) and the NAR resolver picks
    the flash kernel (B <= 8), which takes Dh 128 too."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.serving import SynthesisRequest, Synthesizer

    gen = torch.Generator(cuda_device).manual_seed(0)
    model = VALLE(ValleConfig(d_model=256, nhead=2, num_layers=2,
                              num_quantizers=8, max_len=1024),
                  generator=gen).eval()
    synth = Synthesizer(model, TextTokenizer(backend="char"),
                        TextTokenCollater(list("abcdefghijklmnopqrstuvwxyz_")),
                        AudioTokenizer(device=cuda_device), top_k=5,
                        decode_mode=mode, device=cuda_device)
    rng = np.random.RandomState(0)
    reqs = [SynthesisRequest(text=f"request {w}",
                             prompt_codes=rng.randint(0, 1024, (640, 8)))
            for w in "abcdefgh"]
    cb.reset_launch_counts()
    out = synth.synthesize(reqs, max_gen_len=16)   # cache >= 640
    torch.cuda.synchronize()
    ran = "int8" if mode == "auto" else mode
    assert synth.last_decode_mode == ran
    assert all(cb.LAUNCHES[n] > 0 for n in MODE_KERNELS[ran]), cb.LAUNCHES
    assert cb.LAUNCHES["flash_mha_fwd"] > 0, cb.LAUNCHES
    for res in out:
        assert np.isfinite(res.wav).all()


def _attn_biases(rng, B, H, S, T, dev):
    """The bias broadcasts the kernel reads: the AR composite (B, 1, S, T)
    with padded keys, the NAR key bias (B, 1, 1, T) and a per-head finite
    (B, H, S, T); -inf entries are clamped to -1e30."""
    x_lens = torch.tensor([min(S, T) // 3, min(S, T) // 5], device=dev)
    y_lens = torch.tensor([S - min(S, T) // 3, S // 2], device=dev)
    full = M.ar_xy_attn_bias(x_lens, y_lens, min(S, T) // 3,
                             S - min(S, T) // 3)[..., :T]
    key = M.key_padding_bias(torch.tensor([T, T * 2 // 3], device=dev), T)
    head = _randn(rng, B, H, S, T, dev=dev)
    return {"full": full, "key": key, "head": head}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T", [(289, 289), (439, 439), (200, 333),
                                 (70, 130)])
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, S, T, Dh):
    """B6 over each bias broadcast (a full (B, 1, S, T) bias, the stride-0
    key bias, a per-head bias), from strided views of a fused projection
    as the stacks pass them, S != T with ragged edges; a fully masked row
    stays finite; two launches give the same bits."""
    from valle_tpu_torch.modules.transformer import split_qkv

    rng = np.random.RandomState(Dh + S)
    B, H = 2, 3
    q = split_qkv(_randn(rng, B, S, 3 * H * Dh, dev=cuda_device).to(dtype),
                  H)[0]
    _, k, v = split_qkv(_randn(rng, B, T, 3 * H * Dh,
                               dev=cuda_device).to(dtype), H)
    assert not q.is_contiguous()
    for name, bias in _attn_biases(rng, B, H, S, T, cuda_device).items():
        if name == "full" and S != T:
            continue
        got = pa.flash_attention(q, k, v, bias)
        ref = pa.naive_attention(q, k, v, bias.clamp_min(pa.NEG_INF))
        _close_attn(got, ref, dtype)
        assert torch.equal(got, pa.flash_attention(q, k, v, bias))
    bias = _attn_biases(rng, B, H, S, T, cuda_device)["key"].expand(
        B, 1, S, T).clone()
    bias[0, :, 5] = float("-inf")
    got = pa.fused_attention(q, k, v, bias, use_kernel=True)
    assert torch.isfinite(got).all()
    ref = pa.naive_attention(q, k, v, bias.clamp_min(pa.NEG_INF))
    _close_attn(got, ref, dtype)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_gradient_matches_plain(cuda_device):
    """fp32: the kernel's forward, the plain recompute's backward, against
    autograd through the plain version."""
    rng = np.random.RandomState(5)
    B, H, S, Dh = 2, 4, 289, 64
    qkv = [_randn(rng, B, H, S, Dh, dev=cuda_device).requires_grad_()
           for _ in range(3)]
    g = _randn(rng, B, H, S, Dh, dev=cuda_device)
    bias = _attn_biases(rng, B, H, S, S, cuda_device)["full"]
    before = cb.LAUNCHES["flash_attention"]
    out = pa.flash_attention(*qkv, bias)
    assert cb.LAUNCHES["flash_attention"] == before + 1
    grads = torch.autograd.grad(out, qkv, g)
    ref = pa.naive_attention(*qkv, bias.clamp_min(pa.NEG_INF))
    _close_attn(out, ref, torch.float32)
    for a, b in zip(grads, torch.autograd.grad(ref, qkv, g)):
        _close(a, b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("audio_causal,S_text,S,T", [
    (True, 64, 289, 289), (False, 64, 439, 439), (True, 24, 131, 131),
    (True, 130, 300, 300), (False, 64, 200, 333)])
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_attention_lens_kernel_matches_plain(cuda_device, dtype,
                                                   audio_causal, S_text, S,
                                                   T, Dh):
    """B7 with the AR composite (causal) and NAR padding masks, from
    strided views of a fused projection; rows whose key tiles the kernel
    skips (x_len < 64, y_len 0, above the causal diagonal), a row with no
    text (under the causal mask its text queries see no key: uniform over
    the T keys, finite), S != T (the padding mask); two launches give the
    same bits."""
    from valle_tpu_torch.modules.transformer import split_qkv

    rng = np.random.RandomState(T + Dh)
    B, H = 5, 2
    q = split_qkv(_randn(rng, B, S, 3 * H * Dh, dev=cuda_device).to(dtype),
                  H)[0]
    _, k, v = split_qkv(_randn(rng, B, T, 3 * H * Dh,
                               dev=cuda_device).to(dtype), H)
    Ta = T - S_text
    x_lens = torch.tensor([S_text, S_text // 2, 1, 0, 20],
                          device=cuda_device)
    y_lens = torch.tensor([Ta, Ta // 3, 0, 5, 90], device=cuda_device)
    got = pa.flash_attention_lens(q, k, v, x_lens, y_lens, S_text,
                                  audio_causal)
    mask = pa._lens_bias(x_lens, y_lens, S_text, audio_causal, S, T)
    ref = pa.naive_attention(q, k, v, mask.clamp_min(pa.NEG_INF))
    assert torch.isfinite(got).all()
    _close_attn(got, ref, dtype)
    assert torch.equal(got, pa.flash_attention_lens(q, k, v, x_lens, y_lens,
                                                    S_text, audio_causal))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [32, 6])
@pytest.mark.parametrize("H,Dh", [(16, 64), (8, 128), (4, 32)])
def test_transposed_decode_kernels_match_plain(cuda_device, dtype, B, H, Dh):
    """B8 (any B) and B9 (B % 8 == 0) over the transposed caches, with
    per-row and scalar write positions, at each head dim they take."""
    rng = np.random.RandomState(B)
    T, S = 512, 64
    q, k, v, x_lens, wp = _decode_case(rng, B, H, Dh, T, S, dtype,
                                       cuda_device)
    kt, vt = (x.transpose(-1, -2).contiguous() for x in (k, v))
    for w in (wp, wp[2]):
        ref = dt8.decode_attention_plain(q, kt, vt, x_lens, w, S=S)
        _close_attn(dt8.decode_attention(q, kt, vt, x_lens, w, S=S), ref,
                    dtype)
        if B % 8 == 0:
            _close_attn(dt9.decode_attention_grouped(q, kt, vt, x_lens, w,
                                                     S=S), ref, dtype)
    if B % 8:
        with pytest.raises(ValueError, match="multiple of the group"):
            dt9.decode_attention_grouped(q, kt, vt, x_lens, wp, S=S)
    torch.cuda.synchronize()


def _spread_lengths(rng, B, T, S, dev):
    """x_len in [1, S], write_pos in [S, T); row 0 reads the whole cache,
    row 1 (where there is one) only its first audio key."""
    x_lens = torch.from_numpy(rng.randint(1, S + 1, B)).to(dev)
    wp = torch.from_numpy(rng.randint(S, T, B)).to(dev)
    x_lens[0], wp[0] = S, T - 1
    if B > 1:
        wp[1] = S
    return x_lens, wp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 6, 32])
@pytest.mark.parametrize("T,S", [(333, 61), (2048, 64)])
@pytest.mark.parametrize("H,Dh", [(16, 64), (8, 128), (4, 32)])
def test_transposed_decode_kernel_takes_any_cache(cuda_device, dtype, B, T,
                                                  S, H, Dh):
    """B8 (and B9 where B % 8 == 0) at an odd T (333: rows not 16-byte
    aligned, the element-load path; S 61 not a multiple of a key vector)
    and a long cache (T 2048), at B 1, 6 (the per_sample run's batch) and
    32; two launches give the same bits."""
    rng = np.random.RandomState(T + B + Dh)
    q = _randn(rng, B, H, 1, Dh, dev=cuda_device).to(dtype)
    kt, vt = (_randn(rng, B, H, Dh, T, dev=cuda_device).to(dtype)
              for _ in range(2))
    x_lens, wp = _spread_lengths(rng, B, T, S, cuda_device)
    ref = dt8.decode_attention_plain(q, kt, vt, x_lens, wp, S=S)
    got = dt8.decode_attention(q, kt, vt, x_lens, wp, S=S)
    _close_attn(got, ref, dtype)
    assert torch.equal(got, dt8.decode_attention(q, kt, vt, x_lens, wp, S=S))
    if B % 8 == 0:
        got9 = dt9.decode_attention_grouped(q, kt, vt, x_lens, wp, S=S)
        _close_attn(got9, ref, dtype)
        assert torch.equal(got9, dt9.decode_attention_grouped(
            q, kt, vt, x_lens, wp, S=S))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("B", [5, 13, 1, 32])
@pytest.mark.parametrize("H,Dh", [(16, 64), (8, 128), (32, 32), (10, 64)])
def test_fused_attn_tail_kernel_clusters(cuda_device, dtype, activation, B,
                                         H, Dh):
    """B12 at d_model 1024 (Dh 64, 128 and 32; and 640: clusters of 8 rows
    at any B) with
    rows that do not fill a cluster (B 5, 13, 1: padding blocks) and with
    full clusters (B 32), against the plain version; two launches give the
    same bits."""
    rng = np.random.RandomState(B * Dh)
    T, S, F = 320, 40, 2048
    D = H * Dh
    q = _randn(rng, B, H, 1, Dh, dev=cuda_device).to(dtype)
    k, v = (_randn(rng, B, H, T, Dh, dev=cuda_device).to(dtype)
            for _ in range(2))
    x_lens, wp = _spread_lengths(rng, B, T, S, cuda_device)
    r = lambda *s, scale=1.0: _randn(rng, *s, scale=scale,  # noqa: E731
                                     dev=cuda_device)
    args = (q, r(B, D).to(dtype), dln.combine_kv_lanes(k, v), x_lens, wp,
            r(D, D, scale=D ** -0.5).to(dtype), r(D, scale=0.1),
            1 + r(D, scale=0.1), r(D, scale=0.1),
            r(F, D, scale=D ** -0.5).to(dtype), r(F, scale=0.1),
            r(D, F, scale=F ** -0.5).to(dtype), r(D, scale=0.1))
    got = fat.fused_attn_tail(*args, S=S, activation=activation)
    _close(got, fat.fused_attn_tail_plain(*args, S=S, activation=activation),
           dtype)
    assert torch.equal(got, fat.fused_attn_tail(*args, S=S,
                                                activation=activation))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_attn_tail_kernel_refuses_width_off_its_tiles(cuda_device):
    """B12 at bf16 takes d_model in multiples of 128 (16-column tiles for
    each block of an 8-row cluster); d 576 raises a named error."""
    rng = np.random.RandomState(0)
    B, H, Dh, T, S, F = 4, 9, 64, 128, 40, 1152
    D = H * Dh
    bf = torch.bfloat16
    q = _randn(rng, B, H, 1, Dh, dev=cuda_device).to(bf)
    kv = _randn(rng, B, T, 2 * D, dev=cuda_device).to(bf)
    x_lens, wp = _spread_lengths(rng, B, T, S, cuda_device)
    r = lambda *s: _randn(rng, *s, dev=cuda_device).to(bf)  # noqa: E731
    with pytest.raises(ValueError, match="multiple of 128"):
        fat.fused_attn_tail(q, r(B, D), kv, x_lens, wp, r(D, D), r(D), r(D),
                            r(D), r(F, D), r(F), r(D, F), r(D), S=S)


def _tiny_model(dev, nhead=4):
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    gen = torch.Generator(dev).manual_seed(0)
    return VALLE(ValleConfig(d_model=256, nhead=nhead, num_layers=2,
                             num_quantizers=8, max_len=512),
                 generator=gen).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,B,kernel", [
    ("grouped", 8, "decode_attention_grouped"),
    ("per_sample", 6, "decode_attention"),
    ("grouped", 6, "decode_attention")])
@pytest.mark.parametrize("nhead", [4, 2])
def test_ar_decode_transposed_modes_launch_per_layer(cuda_device, mode, B,
                                                     kernel, nhead):
    """valle_ar_decode in the transposed modes: one launch per layer and
    step ("grouped" at B % 8 != 0 runs "per_sample"), fp32 greedy codes
    equal "exact"'s; at Dh 64 (4 heads) and Dh 128 (2 heads)."""
    from valle_tpu_torch.models.inference import valle_ar_decode

    model = _tiny_model(cuda_device, nhead)
    gen = torch.Generator(cuda_device).manual_seed(1)
    text = torch.randint(3, 30, (B, 16), generator=gen, device=cuda_device)
    tl = torch.full((B,), 16, device=cuda_device)
    tl[1] = 9
    pq = torch.randint(0, 1024, (B, 24), generator=gen, device=cuda_device)
    pl = torch.full((B,), 24, device=cuda_device)
    pl[2] = 17
    args = (model, text, tl, pq, pl)
    cb.reset_launch_counts()
    codes, lens = valle_ar_decode(*args, top_k=1, max_gen_len=12,
                                  force_full_length=True, decode_mode=mode)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[kernel] == 2 * 12, cb.LAUNCHES
    ref = valle_ar_decode(*args, top_k=1, max_gen_len=12,
                          force_full_length=True, decode_mode="exact")
    assert torch.equal(codes, ref[0]) and torch.equal(lens, ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nhead", [4, 2])
def test_mega_greedy_codes_equal_exact(cuda_device, nhead):
    """fp32 greedy decoding through B12 (mode "mega": one launch a layer
    and step, a multiple of the 2 layers) gives the codes of the plain
    "exact" path, at Dh 64 (4 heads) and Dh 128 (2 heads), B 8 with ragged
    text and prompts."""
    from valle_tpu_torch.models.inference import valle_inference

    model = _tiny_model(cuda_device, nhead)
    gen = torch.Generator(cuda_device).manual_seed(6)
    B = 8
    text = torch.randint(3, 30, (B, 16), generator=gen, device=cuda_device)
    tl = torch.tensor([16, 9, 16, 3, 12, 16, 7, 14], device=cuda_device)
    pc = torch.randint(0, 1024, (B, 24, 8), generator=gen,
                       device=cuda_device)
    pl = torch.tensor([24, 17, 24, 10, 21, 24, 13, 19], device=cuda_device)
    args = (model, text, tl, pc, pl)
    cb.reset_launch_counts()
    codes, lens = valle_inference(*args, top_k=1, max_gen_len=12,
                                  decode_mode="mega")
    torch.cuda.synchronize()
    n = cb.LAUNCHES["fused_attn_tail"]
    assert n > 0 and n % 2 == 0, cb.LAUNCHES
    ref = valle_inference(*args, top_k=1, max_gen_len=12,
                          decode_mode="exact")
    assert torch.equal(codes, ref[0]) and torch.equal(lens, ref[1])


def _graph_case(dev):
    """B 8 rows of ragged text and prompts for the AR step graph."""
    gen = torch.Generator(dev).manual_seed(6)
    text = torch.randint(3, 30, (8, 16), generator=gen, device=dev)
    tl = torch.tensor([16, 9, 16, 5, 12, 16, 7, 14], device=dev)
    pq = torch.randint(0, 1024, (8, 24), generator=gen, device=dev)
    pl = torch.tensor([24, 17, 24, 10, 21, 24, 13, 19], device=dev)
    return text, tl, pq, pl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["int8", "fused_int8", "exact", "mega"])
def test_ar_step_graph_equals_the_eager_loop(cuda_device, dtype, mode,
                                             monkeypatch):
    """valle_ar_decode on a card replays its step as a CUDA graph; the
    eager loop (the CPU's, forced here) gives the same sampled codes and
    lengths, bit-equal logits at each of 64 steps and the same kernel
    launches. The graph is captured once and replayed 63 times."""
    from valle_tpu_torch.models import inference as inf
    from valle_tpu_torch.utils import tracing

    model = _tiny_model(cuda_device).to(dtype)
    args = (model,) + _graph_case(cuda_device)
    stop = inf.ar_stop_step

    def run(graphed):
        monkeypatch.setattr(inf, "use_step_graph",
                            lambda stack, dev: graphed)
        logits = []

        def record(lg, g, *a, **k):
            logits.append(lg.clone())
            return stop(lg, g, *a, **k)

        monkeypatch.setattr(inf, "ar_stop_step", record)
        cb.reset_launch_counts()
        tracing.enable()
        try:
            codes, lens = inf.valle_ar_decode(
                *args, generator=torch.Generator(cuda_device).manual_seed(5),
                top_k=5, max_gen_len=64, compute_dtype=dtype,
                decode_mode=mode)
            torch.cuda.synchronize()
        finally:
            tracing.disable()
        names = [sp["name"] for sp in tracing.spans()]
        return (codes, lens, torch.stack(logits), dict(cb.LAUNCHES),
                tracing.counters(), names)

    codes, lens, logits, launched, counters, names = run(True)
    e_codes, e_lens, e_logits, e_launched, e_counters, e_names = run(False)
    assert logits.shape[0] == 64 and torch.equal(logits, e_logits)
    assert torch.equal(codes, e_codes) and torch.equal(lens, e_lens)
    assert launched == e_launched
    if mode != "exact":
        assert sum(launched.values()) > 0, launched
    assert counters["ar.graph_steps"] == 63 and e_counters[
        "ar.graph_steps"] == 0
    assert counters["ar.row_steps"] == e_counters["ar.row_steps"] == 8 * 64
    assert names.count("ar.capture") == 1 and names.count("ar.replay") == 63
    assert "ar.replay" not in e_names and e_names.count("ar.stack") == 64


@pytest.mark.cuda
def test_ar_step_graphs_of_two_threads_at_once(cuda_device):
    """Two threads decoding on one card at once, each capturing and
    replaying its own step graphs, three calls each, both give a lone
    decode's codes. Each call draws from a generator of its own (seeded
    alike): bf16 logits tie, and top-k keeps the ties."""
    import threading

    from valle_tpu_torch.models.inference import valle_ar_decode
    from valle_tpu_torch.utils import tracing

    model = _tiny_model(cuda_device).to(torch.bfloat16)
    args = (model,) + _graph_case(cuda_device)

    def decode():
        return valle_ar_decode(
            *args, generator=torch.Generator(cuda_device).manual_seed(5),
            top_k=5, max_gen_len=64, compute_dtype=torch.bfloat16,
            decode_mode="int8", force_full_length=True)

    alone = decode()
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    out, errors = [[], []], []

    def work(i):
        try:
            start.wait(60)
            for _ in range(3):
                out[i].append(decode())
            torch.cuda.current_stream().synchronize()
        except BaseException as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    tracing.enable()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        tracing.disable()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert tracing.counters()["ar.graph_steps"] == 6 * 63
    for codes, lens in out[0] + out[1]:
        assert torch.equal(codes, alone[0]) and torch.equal(lens, alone[1])


@pytest.mark.cuda
def test_flash_switch_routes_synthesis_through_b6(cuda_device, monkeypatch):
    """VALLE_TPU_FLASH_ATTENTION=1 with the einsum NAR and fp32 scores:
    the AR prefill and each of the 7 NAR passes launch B6 once a layer."""
    from valle_tpu_torch.models.inference import valle_inference

    model = _tiny_model(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    B = 4
    text = torch.randint(3, 30, (B, 64), generator=gen, device=cuda_device)
    tl = torch.full((B,), 64, device=cuda_device)
    pc = torch.randint(0, 1024, (B, 96, 8), generator=gen,
                       device=cuda_device)
    pl = torch.full((B,), 96, device=cuda_device)
    monkeypatch.setenv("VALLE_TPU_FLASH_ATTENTION", "1")
    cb.reset_launch_counts()
    codes, lens = valle_inference(model, text, tl, pc, pl, top_k=1,
                                  max_gen_len=16, decode_mode="fused",
                                  nar_attn_impl="einsum")
    torch.cuda.synchronize()
    assert cb.LAUNCHES["flash_attention"] == 2 + 7 * 2, cb.LAUNCHES
    monkeypatch.delenv("VALLE_TPU_FLASH_ATTENTION")
    ref = valle_inference(model, text, tl, pc, pl, top_k=1, max_gen_len=16,
                          decode_mode="fused", nar_attn_impl="einsum")
    assert torch.equal(lens, ref[1])
    assert (codes == ref[0]).float().mean().item() >= 0.98


@pytest.mark.cuda
def test_train_step_head_dim_128_flash_matches_einsum(cuda_device):
    """fp32, d_model 1024 with 8 heads (Dh 128), 2 layers, B 2, dropout
    off: one AR and one NAR step through the flash kernels give the
    einsum path's loss (1e-5 relative) and grad norm (1e-4)."""
    import copy
    import dataclasses

    from valle_tpu_torch.models import resolve_remat
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    gen = torch.Generator(cuda_device).manual_seed(3)
    base = VALLE(ValleConfig(d_model=1024, nhead=8, num_layers=2,
                             num_quantizers=8, prefix_mode=1),
                 generator=gen)
    B, S, T = 2, 40, 150
    batch = {"text": torch.randint(3, 100, (B, S), generator=gen,
                                   device=cuda_device),
             "text_lens": torch.tensor([S, 29], device=cuda_device),
             "audio": torch.randint(0, 1024, (B, T, 8), generator=gen,
                                    device=cuda_device),
             "audio_lens": torch.tensor([T, 97], device=cuda_device)}
    for stage in (1, 2):
        out = {}
        for impl in ("flash", "einsum"):
            model = copy.deepcopy(base)
            model.cfg = dataclasses.replace(
                model.cfg, attn_impl=impl, remat=resolve_remat("auto", stage))
            opt, lr_fn = make_optimizer(model, train_stage=stage,
                                        device=cuda_device)
            step = make_train_step(lr_fn, train_stage=stage,
                                   device=cuda_device)
            cb.reset_launch_counts()
            m = step(TrainState(model, opt), batch, 0)
            out[impl] = (m["loss"].item(), m["grad_norm"].item())
            launched = cb.LAUNCHES["flash_mha_bwd"]
            assert (launched > 0) == (impl == "flash"), cb.LAUNCHES
        (lf, nf), (le, ne) = out["flash"], out["einsum"]
        assert abs(lf - le) <= 1e-5 * abs(le), out
        assert abs(nf - ne) <= 1e-4 * abs(ne), out


def _prompt_wav(path, seconds=3.0, sr=16_000, seed=0):
    from valle_tpu_torch import native

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    w = (0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t)
         + 0.05 * rng.randn(t.size)).astype(np.float32)
    native.write_wav(path, w, sr)
    return w


@pytest.mark.cuda
def test_encoder_on_card_matches_cpu(cuda_device):
    """A seeded codec encodes 3 s of 24 kHz audio (B 2) on the card and on
    the CPU with TF32 switched on by the caller: the latents the encode
    computes (caught by a hook on the encoder) within 1e-4 of the largest
    entry, codes equal on >= 98% of frames per quantizer; the encode takes
    TF32 off itself and restores the caller's settings."""
    from valle_tpu_torch.codec.model import EncodecModel, encodec_encode
    from valle_tpu_torch.codec.seanet import seanet_encoder_apply

    cpu = EncodecModel(generator=torch.Generator().manual_seed(5)).eval()
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.RandomState(1)
    wav = torch.from_numpy((0.3 * rng.randn(2, 72_000, 1)).astype(
        np.float32).clip(-1, 1))
    seen = []
    hook = card.encoder.register_forward_hook(
        lambda mod, inp, out: seen.append(out.transpose(1, 2).cpu()))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        codes = encodec_encode(card, wav.to(cuda_device))
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = encodec_encode(cpu, wav)
    assert codes.shape == ref.shape == (2, 225, 8)
    share = (codes.cpu() == ref).float().mean(dim=(0, 1))
    assert (share >= 0.98).all(), share
    with torch.no_grad():
        lat_ref = seanet_encoder_apply(cpu.encoder, wav)
    assert len(seen) == 1
    _close(seen[0], lat_ref, torch.float32)


@pytest.mark.cuda
def test_get_model_and_load_model_default_to_the_card(cuda_device,
                                                      tmp_path):
    """get_model and load_model without a device build the model on the
    card, with --attn-impl auto resolved to the flash kernels."""
    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.models import get_model, load_model

    args = infer.get_parser().parse_args(
        ["--decoder-dim", "256", "--nhead", "4", "--num-decoder-layers",
         "1"])
    model = get_model(args)
    assert next(model.parameters()).device.type == "cuda"
    assert model.cfg.attn_impl == "flash"
    torch.save({"model": model.state_dict(), "decoder_dim": 256, "nhead": 4,
                "num_decoder_layers": 1}, tmp_path / "m.pt")
    loaded, _ = load_model(str(tmp_path / "m.pt"))
    assert {p.device.type for p in loaded.parameters()} == {"cuda"}
    assert loaded.cfg == model.cfg


@pytest.mark.cuda
def test_prompt_wav_synthesizer_batch_launches_kernels(cuda_device,
                                                       tmp_path):
    """A bf16 "fused" Synthesizer batch of 4 requests with 16 kHz prompt
    wavs launches B1, B2 and the B4 forward (NAR at B <= 8)."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
    from valle_tpu_torch.serving import SynthesisRequest, Synthesizer

    model = _tiny_model(cuda_device).to(torch.bfloat16)
    synth = Synthesizer(
        model, TextTokenizer(backend="char"),
        TextTokenCollater(list("abcdefghijklmnopqrstuvwxyz_")),
        AudioTokenizer(device=cuda_device), top_k=10,
        compute_dtype=torch.bfloat16, decode_mode="fused", device="cuda")
    reqs = []
    for i, word in enumerate(("one", "two", "three", "four")):
        _prompt_wav(tmp_path / f"{i}.wav", seconds=1.0, seed=i)
        reqs.append(SynthesisRequest(text=f"request number {word}",
                                     prompt_wav=str(tmp_path / f"{i}.wav")))
    cb.reset_launch_counts()
    out = synth.synthesize(reqs, max_gen_len=16)
    torch.cuda.synchronize()
    for k in ("fused_ln_qkv", "fused_tail", "flash_mha_fwd"):
        assert cb.LAUNCHES[k] > 0, cb.LAUNCHES
    assert len(out) == 4
    for r in out:
        assert r.frames > 0 and r.wav.shape == (r.frames * 320,)
        assert np.isfinite(r.wav).all()


@pytest.mark.cuda
def test_infer_cli_on_card(cuda_device, tmp_path):
    """``bin.infer.main --device cuda --decode-mode fused`` on a
    reference-format .pt: fp32 B1/B2 launches and a wav of frames x 320
    samples; ``--continual`` writes one too."""
    from valle_tpu_torch import native
    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.utils.symbol_table import SymbolTable

    model = _tiny_model(torch.device("cpu"))
    table = SymbolTable(eps=None)
    for i, s in enumerate(["<pad>", "<bos>", "<eos>"]
                          + list("abcdefghijklmnopqrstuvwxyz_")):
        table.add(s, i)
    table.to_file(tmp_path / "tokens.k2symbols")
    torch.save({"model": model.state_dict(), "decoder_dim": 256, "nhead": 4,
                "num_decoder_layers": 2,
                "text_tokens": str(tmp_path / "tokens.k2symbols")},
               tmp_path / "m.pt")
    _prompt_wav(tmp_path / "p.wav", seconds=1.0)
    argv = ["--checkpoint", str(tmp_path / "m.pt"), "--text-extractor",
            "char", "--audio-prompts", str(tmp_path / "p.wav"),
            "--text-prompts", "a prompt", "--text", "hello there",
            "--top-k", "1", "--max-gen-len", "16", "--decode-mode", "fused",
            "--device", "cuda"]
    cb.reset_launch_counts()
    infer.main(argv + ["--output-dir", str(tmp_path / "plain")])
    torch.cuda.synchronize()
    assert cb.LAUNCHES["fused_ln_qkv"] > 0, cb.LAUNCHES
    assert cb.LAUNCHES["fused_tail"] > 0, cb.LAUNCHES
    infer.main(argv + ["--output-dir", str(tmp_path / "cont"),
                       "--continual", "true"])
    for d in ("plain", "cont"):
        w, sr = native.read_wav(tmp_path / d / "0.wav")
        assert sr == 24_000 and w.shape[0] > 0 and w.shape[0] % 320 == 0
        assert np.isfinite(w).all()


@pytest.mark.cuda
def test_remat_policies_launch_counts_on_card(cuda_device):
    """bf16, d_model 1024, 16 heads, 2 layers, dropout 0.1, one forward
    and backward per stage and remat policy through the flash pair: B5
    launches once a layer; B4 once a layer under "none" and twice under
    "full", "dots" and "scores" (the kernel call is where the scores
    live, so each of those recomputes it); losses and gradients equal
    "none"'s bit for bit."""
    import copy
    import dataclasses

    from valle_tpu_torch.models.valle import VALLE, ValleConfig, valle_forward

    gen = torch.Generator(cuda_device).manual_seed(4)
    base = VALLE(ValleConfig(d_model=1024, nhead=16, num_layers=2,
                             prefix_mode=1, attn_impl="flash"),
                 generator=gen)
    B, S, T = 4, 64, 200
    batch = {"text": torch.randint(3, 100, (B, S), generator=gen,
                                   device=cuda_device),
             "text_lens": torch.tensor([S, 50, 41, 33], device=cuda_device),
             "audio": torch.randint(0, 1024, (B, T, 8), generator=gen,
                                    device=cuda_device),
             "audio_lens": torch.tensor([T, 180, 150, 120],
                                        device=cuda_device)}
    for stage in (1, 2):
        ref = None
        for remat in ("none", "full", "dots", "scores"):
            model = copy.deepcopy(base)
            model.cfg = dataclasses.replace(model.cfg, remat=remat)
            cb.reset_launch_counts()
            loss, _ = valle_forward(
                model, batch, train_stage=stage,
                generator=torch.Generator().manual_seed(9),
                compute_dtype=torch.bfloat16)
            loss.backward()
            torch.cuda.synchronize()
            assert cb.LAUNCHES["flash_mha_bwd"] == 2, (remat, cb.LAUNCHES)
            assert cb.LAUNCHES["flash_mha_fwd"] == (
                2 if remat == "none" else 4), (remat, cb.LAUNCHES)
            grads = {n: p.grad for n, p in model.named_parameters()
                     if p.grad is not None}
            if ref is None:
                ref = (loss.item(), grads)
                continue
            assert loss.item() == ref[0], remat
            for n, g in grads.items():
                assert torch.equal(g, ref[1][n]), (remat, n)


def _card_trainer_args(corpus, exp, *extra):
    from valle_tpu_torch.bin import trainer

    return trainer.get_parser().parse_args([
        "--manifest-dir", str(corpus), "--text-tokens",
        str(corpus / "unique_text_tokens.k2symbols"), "--exp-dir", str(exp),
        "--decoder-dim", "1024", "--nhead", "16", "--num-decoder-layers",
        "2", "--prefix-mode", "1", "--train-stage", "1", "--dtype",
        "bfloat16", "--num-epochs", "1", "--max-duration", "20",
        "--max-steps-per-epoch", "3", "--save-every-n", "2",
        "--keep-last-k", "1", "--valid-interval", "3", "--log-interval", "1",
        "--num-workers", "0", "--tensorboard", "false", *extra])


@pytest.mark.cuda
def test_trainer_on_card(cuda_device, tmp_path, monkeypatch):
    """The trainer CLI's run() on the card: 2 layers at d_model 1024, bf16,
    AR stage (remat full), 3 steps with the OOM scan and one validation:
    B4/B5 launch exactly as the layers, steps, scan batches and
    validation batches say; 2 steps + a resume from checkpoint-2.pt + 1
    step end with the 3-step run's weights and optimizer state, bit for
    bit. The corpus lives in memory (the card machine has no h5py)."""
    from torch_port_corpus import MemoryStore, write_corpus

    from valle_tpu_torch.bin import trainer
    from valle_tpu_torch.data import manifests
    from valle_tpu_torch.utils.checkpoint import load_checkpoint

    store = MemoryStore()
    corpus = write_corpus(tmp_path / "corpus", n_train=12, n_dev=2,
                          train_frames=(150, 400), dev_frames=200,
                          store=store)
    monkeypatch.setattr(manifests, "_cached_store", lambda path: store)
    cb.reset_launch_counts()
    stats = trainer.run(_card_trainer_args(corpus, tmp_path / "a"))
    L = 2
    assert stats.steps == 3 and stats.valid_batches == 1
    bwd = L * (stats.steps + stats.scan_batches)
    assert cb.LAUNCHES["flash_mha_bwd"] == bwd, cb.LAUNCHES
    assert cb.LAUNCHES["flash_mha_fwd"] == 2 * bwd + L * stats.valid_batches
    trainer.run(_card_trainer_args(corpus, tmp_path / "b",
                                   "--max-steps-per-epoch", "2"))
    resumed = trainer.run(_card_trainer_args(corpus, tmp_path / "b",
                                             "--start-batch", "2"))
    assert resumed.steps == 1 and resumed.optimizer_restored
    a = load_checkpoint(tmp_path / "a" / "epoch-1.pt")
    b = load_checkpoint(tmp_path / "b" / "epoch-1.pt")
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
