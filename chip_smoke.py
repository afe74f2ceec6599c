"""Drive the PyTorch port of VALL-E synthesis once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. build   -- compile the CUDA kernels under valle_tpu_torch/csrc/.
2. kernels -- each kernel against its plain PyTorch version at the main
              path's shapes, fp32 (TF32 off) and bf16. Limits: relative
              max-abs error <= 1e-4 at fp32, <= 2e-2 at bf16.
3. e2e     -- a full-width VALL-E (12 layers, d_model 1024, 16 heads,
              8 quantizers, prefix_mode 1) with seeded random weights, bf16,
              through ``valle_tpu_torch.serving.Synthesizer``: 8 requests in
              decode mode "fused" and 4 in "fused_w8", with 225-frame
              prompts; every kernel must launch during these runs. Then a
              fp32 check that greedy codes of the kernel path equal the
              plain path's on a small input.
4. timing  -- AR decode frames/s at the bench shape (B 32, text 64,
              prompt 225, 150 frames) for "fused" and "exact", one NAR pass
              flash vs einsum, codec decode of 150 frames, each kernel vs
              its plain version (device time from CUDA-graph replay, and
              the eager per-call time), and the device busy share of
              fused AR decode from a torch.profiler trace.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/ when that
directory can be written.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

FP32_LIMIT = 1e-4   # relative max-abs error vs the plain version, fp32
BF16_LIMIT = 2e-2   # the same at bf16

KERNELS = {
    "fused_ln_qkv": ("valle_tpu_torch/csrc/fused_dense.cu",
                     "valle_tpu/ops/fused_dense.py:114"),
    "fused_tail": ("valle_tpu_torch/csrc/fused_dense.cu",
                   "valle_tpu/ops/fused_dense.py:201"),
    "flash_mha_fwd": ("valle_tpu_torch/csrc/flash_mha_fwd.cu",
                      "valle_tpu/ops/flash_mha.py:114"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time per fn() over ``iters`` back-to-back calls (CUDA events).
    For a call made from Python this is the larger of its host time and its
    device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters=50):
    """Device time per fn(): fn is captured once in a CUDA graph and the
    graph replayed, so host overhead does not hide the device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, iters=iters, warmup=3)


def compare(name, got, ref, limit, errs):
    got, ref = got.float(), ref.float()
    if not bool(torch_isfinite(got)):
        raise RuntimeError(f"{name}: non-finite kernel output")
    abs_err = (got - ref).abs().max().item()
    rel = abs_err / max(ref.abs().max().item(), 1e-30)
    ok = rel <= limit
    log(f"  {name}: max_abs={abs_err:.3e} rel={rel:.3e} limit={limit:g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: relative error {rel:.3e} > {limit:g}")
    errs.append(abs_err)


def torch_isfinite(t):
    import torch

    return torch.isfinite(t).all()


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------


def dense_inputs(B, D, F, dt, gen):
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale)

    p = {"h": r(B, D).to(dt), "a": r(B, D).to(dt),
         "ln_w": (1 + 0.1 * r(D)), "ln_b": 0.1 * r(D),
         "in_w": r(3 * D, D, scale=D ** -0.5), "in_b": 0.1 * r(3 * D),
         "out_w": r(D, D, scale=D ** -0.5), "out_b": 0.1 * r(D),
         "w1": r(F, D, scale=D ** -0.5), "b1": 0.1 * r(F),
         "w2": r(D, F, scale=F ** -0.5), "b2": 0.1 * r(D)}
    return p


def dense_weights(p, dt, int8):
    from valle_tpu_torch.ops.fused_dense import quantize_weights_per_channel

    out = {}
    for n in ("in_w", "out_w", "w1", "w2"):
        w = p[n].to(dt)
        out[n], out[n + "_s"] = (quantize_weights_per_channel(w) if int8
                                 else (w, None))
    return out


def check_kernels(errs):
    import torch

    from valle_tpu_torch.ops import fused_dense as fd
    from valle_tpu_torch.ops import masks as M
    from valle_tpu_torch.ops.flash_mha import (CODE_INVALID,
                                               flash_mha_forward,
                                               reference_mha)

    gen = torch.Generator("cuda").manual_seed(0)
    D, F = 1024, 4096
    for B in (8, 32):
        for dt, int8 in ((torch.float32, False), (torch.float32, True),
                         (torch.bfloat16, False), (torch.bfloat16, True)):
            limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
            p = dense_inputs(B, D, F, dt, gen)
            w = dense_weights(p, dt, int8)
            tag = f"B{B} {str(dt)[6:]} w{'int8' if int8 else str(dt)[6:]}"
            got = fd.fused_ln_qkv(p["h"], p["ln_w"], p["ln_b"], w["in_w"],
                                  p["in_b"], w_scale=w["in_w_s"])
            ref = fd.fused_ln_qkv_plain(p["h"], p["ln_w"], p["ln_b"],
                                        w["in_w"], p["in_b"],
                                        w_scale=w["in_w_s"])
            compare(f"fused_ln_qkv {tag}", got, ref, limit,
                    errs["fused_ln_qkv"])
            for act in (("relu", "gelu") if B == 8 else ("relu",)):
                args = (p["a"], p["h"], w["out_w"], p["out_b"], p["ln_w"],
                        p["ln_b"], w["w1"], p["b1"], w["w2"], p["b2"])
                sc = ((w["out_w_s"], w["w1_s"], w["w2_s"]) if int8 else None)
                got = fd.fused_tail(*args, activation=act, w_scales=sc)
                ref = fd.fused_tail_plain(*args, activation=act, w_scales=sc)
                compare(f"fused_tail {tag} {act}", got, ref, limit,
                        errs["fused_tail"])

    B, H, Dh = 8, 16, 64
    S = 64 + 225 + 150
    for dt in (torch.float32, torch.bfloat16):
        limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
        q, k, v = (torch.randn(B, H, S, Dh, generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        lens = torch.randint(S // 2, S + 1, (B,), generator=gen,
                             device="cuda")
        key_valid = torch.arange(S, device="cuda")[None] < lens[:, None]
        # AR composite: text (code 0) then causal audio (code t + 1);
        # padded keys get CODE_INVALID
        base = torch.arange(S, device="cuda", dtype=torch.int32)
        base = torch.where(base < 64, 0, base - 63).to(torch.int32)
        ar_kc = torch.where(key_valid, base[None], CODE_INVALID)
        cases = {"padded keys": M.flash_codes_key_valid(key_valid),
                 "ar composite": (base.expand(B, S).contiguous(),
                                  ar_kc.to(torch.int32))}
        for cname, (qc, kc) in cases.items():
            got, lse = flash_mha_forward(q, k, v, qc, kc)
            ref, ref_lse = reference_mha(q, k, v, qc, kc, return_lse=True)
            compare(f"flash_mha_fwd {str(dt)[6:]} {cname}", got, ref, limit,
                    errs["flash_mha_fwd"])
            compare(f"flash_mha_fwd lse {str(dt)[6:]} {cname}", lse,
                    ref_lse, FP32_LIMIT, [])
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------

FULL = dict(d_model=1024, nhead=16, num_layers=12, prefix_mode=1,
            num_quantizers=8, max_len=4096)
TEXTS = ["the quick brown fox jumps over the lazy dog",
         "zero shot speech synthesis with a neural codec language model",
         "hello world", "a short one", "speak this sentence please",
         "another request arrives at the server", "testing one two three",
         "the final request of this batch"]


def build_synth(model, audio_tok, decode_mode):
    import torch

    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import TextTokenizer
    from valle_tpu_torch.serving import Synthesizer

    symbols = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
    return Synthesizer(model, TextTokenizer(backend="char"),
                       TextTokenCollater(symbols), audio_tok, top_k=10,
                       max_gen_len=150, compute_dtype=torch.bfloat16,
                       decode_mode=decode_mode, codec_dtype="bfloat16",
                       wav_transfer="pcm16", seed=1, device="cuda")


def check_results(results, n):
    import numpy as np

    if len(results) != n:
        raise RuntimeError(f"expected {n} results, got {len(results)}")
    for r in results:
        if r.frames <= 0 or r.codes.shape != (r.frames, 8):
            raise RuntimeError(f"bad codes shape {r.codes.shape}")
        if r.wav.shape != (r.frames * 320,):
            raise RuntimeError(f"wav length {r.wav.shape} != frames*320")
        if not np.isfinite(r.wav).all():
            raise RuntimeError("non-finite wav")
        if r.codes.min() < 0 or r.codes.max() >= 1024:
            raise RuntimeError("codes out of [0, 1024)")


def run_e2e(model, audio_tok, info):
    import numpy as np
    import torch

    from valle_tpu_torch.models.inference import valle_inference
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.serving import SynthesisRequest

    rng = np.random.RandomState(0)
    reqs = [SynthesisRequest(text=t,
                             prompt_codes=rng.randint(0, 1024, (225, 8)))
            for t in TEXTS]
    synths = {m: build_synth(model, audio_tok, m)
              for m in ("fused", "fused_w8")}
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res8 = synths["fused"].synthesize(reqs, max_gen_len=150)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts_fused = dict(cb.LAUNCHES)
    res4 = synths["fused_w8"].synthesize(reqs[:4], max_gen_len=150)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cb.LAUNCHES)
    counts_w8 = {k: launches[k] - counts_fused[k] for k in launches}
    log(f"  fused    8 requests: {t1 - t0:.3f} s, frames "
        f"{[r.frames for r in res8]}, launches {counts_fused}")
    log(f"  fused_w8 4 requests: {t2 - t1:.3f} s, frames "
        f"{[r.frames for r in res4]}, launches {counts_w8}")
    check_results(res8, 8)
    check_results(res4, 4)
    for name, counts in (("fused", counts_fused), ("fused_w8", counts_w8)):
        for k, n in counts.items():
            if n <= 0:
                raise RuntimeError(f"{k} never launched in the {name} run")
    info["launches"] = launches
    info["e2e_s"] = {"fused_8req": t1 - t0, "fused_w8_4req": t2 - t1}
    return reqs


def check_reference(model32):
    """fp32, greedy: the kernel path's codes equal the plain path's."""
    import torch

    from valle_tpu_torch.models.inference import valle_inference

    gen = torch.Generator("cuda").manual_seed(3)
    B, S, P = 2, 32, 64
    text = torch.randint(3, 30, (B, S), generator=gen, device="cuda")
    tl = torch.tensor([32, 20], device="cuda")
    pc = torch.randint(0, 1024, (B, P, 8), generator=gen, device="cuda")
    pl = torch.tensor([64, 50], device="cuda")
    out = {}
    for dm, na in (("exact", "einsum"), ("fused", "flash")):
        out[dm] = valle_inference(model32, text, tl, pc, pl, top_k=1,
                                  max_gen_len=24, decode_mode=dm,
                                  nar_attn_impl=na)
    same = (torch.equal(out["exact"][0], out["fused"][0])
            and torch.equal(out["exact"][1], out["fused"][1]))
    log(f"  fp32 greedy codes, fused+flash vs exact+einsum: "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise RuntimeError("kernel path codes differ from the plain path")


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------


def time_ar(model, info):
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode

    B, S, P, GEN = 32, 64, 225, 150
    gen = torch.Generator("cuda").manual_seed(5)
    text = torch.randint(0, 100, (B, S), generator=gen, device="cuda")
    tl = torch.full((B,), S, device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    pl = torch.full((B,), P, device="cuda")
    res = {}
    for mode in ("fused", "exact"):
        def run():
            return valle_ar_decode(model, text, tl, pq, pl, generator=gen,
                                   top_k=10, max_gen_len=GEN,
                                   compute_dtype=torch.bfloat16,
                                   force_full_length=True, decode_mode=mode)
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        res[mode] = {"s": times, "frames_per_s": B * GEN / best,
                     "ms_per_step": best / GEN * 1e3}
        log(f"  AR decode {mode}: {B * GEN / best:.1f} frames/s "
            f"({best / GEN * 1e3:.3f} ms/step, runs {times})")
    info["ar_decode"] = res


def time_nar(model, info):
    import torch

    from valle_tpu_torch.modules.transformer import encoder_stack_apply
    from valle_tpu_torch.ops import masks as M

    gen = torch.Generator("cuda").manual_seed(6)
    T = 64 + 225 + 150
    res = {}
    for B in (8, 32):
        seq = torch.randn(B, T, 1024, generator=gen,
                          device="cuda").to(torch.bfloat16)
        lens = torch.full((B,), T - 10, device="cuda")
        key_valid = torch.arange(T, device="cuda")[None] < lens[:, None]
        qc, kc = M.flash_codes_key_valid(key_valid)
        bias = torch.zeros(key_valid.shape, device="cuda").masked_fill(
            ~key_valid, float("-inf"))[:, None, None, :]
        cond = model.nar_stage_embeddings[0].word_embeddings.weight
        for impl in ("flash", "einsum"):
            kw = ({"flash_spec": {"qcode": qc, "kcode": kc}}
                  if impl == "flash" else {"score_bf16": True})
            def one_pass():
                return encoder_stack_apply(
                    model.nar_decoder, seq, None if impl == "flash" else bias,
                    cond, dtype=torch.bfloat16, **kw)

            ms = cuda_ms(one_pass, iters=5, warmup=1)
            dev = graph_ms(one_pass, iters=5)
            res[f"B{B}_{impl}_ms"] = ms
            res[f"B{B}_{impl}_device_ms"] = dev
            log(f"  NAR pass B={B} T={T} {impl}: {ms:.3f} ms eager, "
                f"{dev:.3f} ms device")
    info["nar_pass"] = res


def time_codec(audio_tok, info):
    import torch

    from valle_tpu_torch.codec.model import encodec_decode

    gen = torch.Generator("cuda").manual_seed(7)
    res = {}
    for B in (1, 8):
        codes = torch.randint(0, 1024, (B, 150, 8), generator=gen,
                              device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            ms = cuda_ms(lambda: encodec_decode(audio_tok.codec, codes,
                                                dtype=dt), iters=5, warmup=1)
            res[f"B{B}_{str(dt)[6:]}_ms"] = ms
            log(f"  codec decode B={B} 150 frames {str(dt)[6:]}: {ms:.3f} ms")
    info["codec_decode"] = res


def time_kernels(times):
    import torch

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import fused_dense as fd
    from valle_tpu_torch.ops import masks as M
    from valle_tpu_torch.ops.flash_mha import (flash_mha_forward,
                                               reference_mha)

    gen = torch.Generator("cuda").manual_seed(8)
    dt = torch.bfloat16
    p = dense_inputs(32, 1024, 4096, dt, gen)
    saved = dict(cb.LAUNCHES)
    for int8 in (False, True):
        w = dense_weights(p, dt, int8)
        sfx = "_w8" if int8 else ""
        qkv = (p["h"], p["ln_w"], p["ln_b"], w["in_w"], p["in_b"])
        times[f"fused_ln_qkv{sfx}"] = pair_ms(
            lambda: fd.fused_ln_qkv(*qkv, w_scale=w["in_w_s"]),
            lambda: fd.fused_ln_qkv_plain(*qkv, w_scale=w["in_w_s"]))
        args = (p["a"], p["h"], w["out_w"], p["out_b"], p["ln_w"], p["ln_b"],
                w["w1"], p["b1"], w["w2"], p["b2"])
        sc = (w["out_w_s"], w["w1_s"], w["w2_s"]) if int8 else None
        times[f"fused_tail{sfx}"] = pair_ms(
            lambda: fd.fused_tail(*args, w_scales=sc),
            lambda: fd.fused_tail_plain(*args, w_scales=sc))
    B, H, S, Dh = 8, 16, 64 + 225 + 150, 64
    q, k, v = (torch.randn(B, H, S, Dh, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    kv = torch.arange(S, device="cuda")[None].expand(B, S) < S - 10
    qc, kc = M.flash_codes_key_valid(kv)
    times["flash_mha_fwd"] = pair_ms(
        lambda: flash_mha_forward(q, k, v, qc, kc),
        lambda: reference_mha(q, k, v, qc, kc))
    cb.LAUNCHES.update(saved)   # timing launches do not count
    for name, (ms, plain, eager, plain_eager) in times.items():
        log(f"  {name}: device kernel {ms:.4f} ms, plain {plain:.4f} ms; "
            f"eager call kernel {eager:.4f} ms, plain {plain_eager:.4f} ms "
            "(bf16; dense B=32, flash B=8 H=16 S=439)")


def pair_ms(kernel, plain):
    """(device ms kernel, device ms plain, eager ms kernel, eager ms
    plain), measured in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (graph_ms(plain), graph_ms(kernel), graph_ms(kernel),
                      graph_ms(plain))
    return (min(k1, k2), min(p1, p2), cuda_ms(kernel), cuda_ms(plain))


def device_busy(model, info):
    """Device busy share of fused AR decode at the bench shape, from a
    torch.profiler trace: union of kernel intervals over the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from valle_tpu_torch.models.inference import valle_ar_decode

    B, S, P = 32, 64, 225
    gen = torch.Generator("cuda").manual_seed(9)
    text = torch.randint(0, 100, (B, S), generator=gen, device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    n = torch.full((B,), S, device="cuda")
    pl = torch.full((B,), P, device="cuda")

    def run():
        valle_ar_decode(model, text, n, pq, pl, generator=gen, top_k=10,
                        max_gen_len=30, compute_dtype=torch.bfloat16,
                        force_full_length=True, decode_mode="fused")
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    path = Path("chiprun_out") / "trace_ar_fused.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            key = e["name"][:60]
            by_name[key] = by_name.get(key, 0.0) + e["dur"]
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        log("  device busy share: not measured (no kernel events in trace)")
        return
    window = (spans[-1][1] - spans[0][0]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    info["ar_fused_profile"] = {
        "wall_ms": wall * 1e3, "kernel_window_ms": window,
        "busy_ms": busy / 1e3, "busy_share": busy / 1e3 / window,
        "kernels": len(spans),
        "top_kernels_ms": {k: v / 1e3 for k, v in top}}
    log(f"  AR fused 30 steps (B=32): wall {wall * 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms of {window:.1f} ms "
        f"({100 * busy / 1e3 / window:.1f}%), {len(spans)} kernels")
    for k, v in top:
        log(f"    {v / 1e3:8.2f} ms  {k}")


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from valle_tpu_torch.ops import cuda_build as cb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path("chiprun_out")
    info = {"device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"device {info['device']}, torch {info['torch']}, "
        f"cuda {info['cuda']}")

    log("phase 1: build")
    t0 = time.perf_counter()
    cb.load_library()
    info["build_s"] = time.perf_counter() - t0
    log(f"  kernels built and loaded in {info['build_s']:.2f} s "
        f"(nvcc {cb.build_info['seconds']}) -> {cb.build_info['path']}")
    for line in cb.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas:", line.strip())

    log("phase 2: kernels vs plain versions")
    errs = {k: [] for k in KERNELS}
    check_kernels(errs)

    log("phase 3: end to end through Synthesizer")
    from valle_tpu_torch.data.tokenizer import AudioTokenizer
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    gen = torch.Generator("cuda").manual_seed(0)
    model32 = VALLE(ValleConfig(**FULL), generator=gen).eval()
    check_reference(model32)
    model = model32.to(torch.bfloat16)
    del model32
    audio_tok = AudioTokenizer(device="cuda", seed=0)
    run_e2e(model, audio_tok, info)
    log("phase 4: timings")
    time_ar(model, info)
    time_nar(model, info)
    time_codec(audio_tok, info)
    times = {}
    time_kernels(times)
    device_busy(model, info)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    info["nvidia_smi"] = card
    launches = info.get("launches", {})
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches.get(n, 0),
                "max_abs_err": max(errs[n]),
                "ms": times.get(n, (None, None))[0],
                "plain_ms": times.get(n, (None, None))[1]}
               for n, (src, rep) in KERNELS.items()]
    info["kernels"] = kernels
    info["kernel_times"] = times
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(info, indent=1))
    except OSError:
        pass
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
