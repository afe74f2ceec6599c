"""Drive the PyTorch port of VALL-E synthesis once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. build   -- compile the CUDA kernels under valle_tpu_torch/csrc/.
2. kernels -- each kernel against its plain PyTorch version at the main
              path's shapes, fp32 (TF32 off) and bf16. Limits: relative
              max-abs error <= 1e-4 at fp32, <= 2e-2 at bf16. The dense
              kernels (fused_ln_qkv, fused_tail) at d_model 1024, FFN
              4096, B 1, 8, 32 and 65, bf16 and int8 weights, two
              launches bit-equal. The decode
              attention kernels (int8, kv, lanes) at B 32, H 16, Dh 64,
              cache 512 with spread lengths, and at H 8, Dh 128; the
              int8 kernel also at the edges of its bulk-copied key runs
              (no text key, the whole cache, runs ending off 4 keys and
              off its 128-key chunk, one row, a 2048-row cache), two
              launches bit-equal;
              fused_attn_tail at d_model 1024, FFN 4096 (both head
              dims, bf16 launched twice bit-equal). The attention kernels
              B6-B9 (held at fp32
              to an absolute 2e-5, JAX's tolerance, at bf16 to 2e-2
              relative): flash_attention at the AR prefill (B 8, H 16,
              S = T = 289, the composite bias) and NAR (S = T = 439, a
              (B, 1, 1, T) key bias) shapes, Dh 128 at S 200 / T 333
              with a fully masked row, its gradient at fp32;
              flash_attention_lens with the AR and NAR masks; both at
              Dh 128 (8 heads) too, and flash_attention_lens with
              lengths whose key tiles the kernel skips (x_len < 64,
              y_len 0, a row with no text), two launches bit-equal;
              decode_attention (B 32 and B 6, two launches bit-equal) and
              decode_attention_grouped (B 32) over the transposed cache at
              the bench step, Dh 64 and 128; the flash training pair at
              Dh 128 (B 16, H 8, S = T = 471, AR codes and a query that
              sees no key; as in phase 5a).
3. e2e     -- a full-width VALL-E (12 layers, d_model 1024, 16 heads,
              8 quantizers, prefix_mode 1) with seeded random weights, bf16,
              through ``valle_tpu_torch.serving.Synthesizer``: 8 requests in
              decode mode "fused" and 4 in "fused_w8", with 225-frame
              prompts; then 8 requests in "auto" with a 512-frame budget,
              which must resolve to "int8" and launch its kernel, and 8 in
              each of "fused_int8", "bf16", "fused_kv", "lanes",
              "fused_lanes" and "mega"; every kernel of a mode must launch
              in its run. Then fp32 greedy checks at B 8: every token-exact
              kernel mode gives the codes of "exact" ("grouped" and
              "per_sample" through valle_ar_decode), and "int8" /
              "fused_int8" through the kernels agree with the plain int8
              path (the port on the CPU) on >= 98% of codes, at 24
              frames and (2 layers, full length) at 150 and 735. The
              flash
              switch (VALLE_TPU_FLASH_ATTENTION=1, NAR einsum, fp32 NAR
              scores): at fp32 the prefill's hidden states and a NAR
              pass's logits equal the switch-off run's within 1e-5 of the
              largest entry; 8 bf16 requests launch flash_attention 96
              times (12 prefill + 7 x 12 NAR), and the same batch on a
              bf16 model at Dh 128 (8 heads, 2 layers) 16 times (2 + 7 x
              2). valle_ar_decode "grouped"
              at B 32 and "per_sample" at B 6 launch their kernel 12 times
              a step. At Dh 128 (8 heads, 2 layers): fp32 greedy codes of
              "mega", "grouped" and "per_sample" equal "exact"'s at B 8;
              bf16 "mega" and "int8" (8 requests each) and the two
              transposed runs launch their kernels.
3b. prompt wav -- the same full-width model, fp32, saved as a
              reference-format .pt with its hyperparameters, the seeded
              codec saved in the encodec package's weight-normed form, and
              seeded 3 s 16 kHz prompt wavs. The prompt encoded on the
              card with TF32 switched on outside the encode, and on the CPU
              with the same codec: the encode's latents within 1e-4 of the
              largest entry, codes equal on >= 98% of the frames of each
              quantizer, TF32 settings restored (the same encode without
              its TF32 guard is logged). ``valle_tpu_torch.bin.infer.main``
              in-process under PyTorch's default TF32 settings with
              ``--decode-mode fused --device cuda``: plainly (B1 and
              B2 must launch), with ``--continual true`` (113 frames out
              of the 225-frame prompt) and on a two-line TSV; each wav
              finite, frames x 320 samples. A bf16 "fused" Synthesizer
              batch of 8 requests with prompt wavs must launch B1, B2 and
              the B4 forward; its wall time and the CLI's are logged.
4. timing  -- AR decode frames/s at the bench shape (B 32, text 64,
              prompt 225, 150 frames) for every decode mode ("grouped"
              and "per_sample" included; one run a mode), and at a
              long cache (735 frames, one run) for "int8", "fused_int8",
              "fused", "exact", "fused_kv", "fused_lanes" and "mega";
              Synthesizer seconds with the flash switch on and off; one
              NAR pass flash vs einsum, codec decode of 150
              frames and encode of 3 s (B 1 and 8, fp32), each kernel
              vs its plain version (device time from CUDA-graph replay,
              and the eager per-call time; the dense
              kernels with bf16 and int8 weights, each with its bound),
              the dense wrappers' kernels a call (fused_ln_qkv 1,
              fused_tail 3, else a failure) and whether programmatic
              dependent launch overlaps fused_tail's kernels eagerly and
              in a CUDA graph, the device busy share of fused and int8 AR
              decode from a torch.profiler trace, and the kernels a step
              of fused and mega AR decode. flash_attention and
              flash_attention_lens are timed at Dh 64 and 128, with the
              share of key tiles flash_attention_lens skips.
              decode_attention, decode_attention_grouped,
              decode_attention_int8_grouped and fused_attn_tail are timed
              at Dh 128 too; fused_attn_tail's
              launches apart (profiler trace) and beside the fused_lanes
              sequence (decode_attention_lanes + fused_tail);
              decode_attention at B 6 and 32 and the kernels over the
              combined caches at B 8 and 32, caches 512 and 1024, against
              their bound.
5. training -- (a) the flash forward and backward kernels against their
              plain versions at the AR recipe's attention shape (B 16,
              H 16, S = T = 471, AR codes), at the NAR recipe's (B 8,
              padding codes) and with one query that sees no key (its
              cotangent zero), fp32 and bf16, dropout 0 and 0.1 with one
              Philox seed; two backward launches give the same bits, and
              the kernels' in-kernel Philox and the plain bytes handed in
              must give bit-equal results; then at the packed shape (B 8,
              H 16, S = T = 1280: the packing sampler's first batch of
              the 5f corpus with its last row emptied, AR and NAR codes,
              segment ids, add_diag), with the share of key tiles B4
              visits there. (b) fp32 at full
              width, B 2: one AR and one NAR train step, flash (kernels) vs
              einsum (plain), dropout off: loss within 1e-5 relative,
              grad_norm within 1e-4; the same at Dh 128 (8 heads, 2
              layers). (c) five bf16 ScaledAdam + Eden steps
              at the AR recipe (B 16, text 96, audio 375, remat full) and
              five at the NAR recipe (B 8, remat none), dropout 0.1: finite
              losses and grad norms, flash_mha_bwd launched 12 times per
              step, flash_mha_fwd 24 (AR, the remat recompute included) or
              12 (NAR); the same bf16 steps first on a model at Dh 128
              (8 heads, 2 layers). (d) train ms/step flash vs einsum, the
              flash
              kernels' device time against their bound and against
              scaled_dot_product_attention (timed here only) at the same
              dropout rate (0 and 0.1), the share of key tiles the kernels
              skip, and the device busy share of the AR step; the
              forward and backward timings again at Dh 128 (8 heads).
              (e) the trainer CLI on the card: a seeded corpus in a
              temporary directory (64 train and 8 dev cuts of 150-600
              frames of random codes, 20-100 char tokens each; the codes
              in HDF5, or in memory where h5py is missing), then
              ``valle_tpu_torch.bin.trainer.run`` at full width cut to
              TRAINER_LAYERS (6) layers, bf16, --attn-impl auto (must
              resolve to flash): stage 1 (the AR
              recipe's flags, 4 steps, checkpoints every 2, validation at
              step 4), then stage 2 from its epoch-1.pt (a stage switch:
              the optimizer state dropped, the AR parameters unmoved, a
              float64 model average written). The flash pair's launches
              in each stage equal the count from the layers, the steps,
              the OOM scan's batches, the validation batches and the
              stage's remat, exactly. ``python -m valle_tpu_torch.bin.infer``
              then synthesizes from epoch-2.pt (fused, 64 frames) in a
              subprocess and its wav is checked. Logged: the trainer's
              ms/step and loader-wait share per stage, and the seconds and
              bytes of each checkpoint write.
              (f) sequence packing: a seeded corpus of 110 cuts like 5e's;
              fp32, dropout off, one packed AR step and one packed NAR step
              (8 rows of 256 + 1024 positions) through the kernels give
              the einsum path's loss (1e-5 relative) and grad norm
              (1e-4), and the packed AR loss of row 0 equals the sum of
              its segments' exact-length forwards (1e-5); then
              ``bin/trainer.py run`` at full width, bf16, --ar-pack
              (stage 1, remat full) and --nar-pack (stage 2, prefix mode
              1, remat none, resumed from stage 1's epoch-1.pt; 2
              checkpoint writes in all), 4 steps each, finite losses and
              exact B4/B5 launches. Logged: ms/step and the padding
              share of packed against bucketed batches over an epoch.
              (g) data parallel: ``torchrun`` starts this script as two
              ranks on the one card over gloo (``--dp-share-device
              true``), stage 0 at full width cut to DP_LAYERS (4)
              layers, 3 steps: at fp32 with
              dropout off the step losses equal a one-process run's on
              the same global batches (1e-5 relative), the parameters
              agree within 1e-4 and the ranks are bit-equal; at bf16
              with dropout 0.1 the losses are finite, the ranks
              bit-equal and B4/B5 launched as counted on each rank;
              then one rank over NCCL. Checkpoint saves are recorded,
              not written; rank 0 alone saves. Logged: the gradient
              all-reduce's seconds and bytes a step.
6. serving -- continuous batching and the HTTP server on phase 3b's
              checkpoint and codec (slots 8, text 64, prompts 256, budget
              512, chunks of 64: a 0.33 GB bf16 slot table).
              (a) fp32, greedy, budget 64: the sync-free categorical draw
              gives torch.multinomial's indices; 8 requests admitted in
              one wave give valle_ar_decode's codes and lengths at B 8 on
              the same padding, greedy and at top_k 10 from one CUDA
              generator seed; 12 requests through 4 slots ("lpt" and
              "fifo") give the Synthesizer's ("exact") codes request by
              request (a difference logs its frame and top-2 logit margin
              and fails the phase). (b) bf16: 24 requests with 225-frame
              prompts and seeded 2-30 character texts, in turns through
              the ContinuousBatcher, the Synthesizer in "exact" and in
              "fused" (plan_groups' groups of 8): the B4 forward launched
              exactly groups x 7 x NAR layers in each CB run; a CB run
              with the flash switch on
              (NAR einsum, fp32 scores) launches B6 exactly waves x layers
              + groups x 7 x NAR layers (the 12 shortest requests).
              Logged: wall s, frames/s, chunks, waves, steps, install_s,
              decode_s, and the device busy share of a CB run of the 6
              shortest requests. (c)
              ``python -m valle_tpu_torch.bin.serve`` in subprocesses:
              ``--mode continuous --slots 8`` answers /healthz and 16
              concurrent requests (8 with prompt codes, 8 with prompt wavs)
              with 24 kHz mono wavs of frames x 320 samples, one
              codes_only answer (frames, 8) in 0-1023 within its 16x cap;
              ``--mode static --decode-mode fused`` one request; both
              stopped.
7. variants -- VALL-F, prenets and post-norm stacks (no profiler trace).
              (a) fp32, TF32 off, d 1024, 16 heads, 2 layers, seeded
              weights: VALL-F greedy codes on the card equal the port's on
              the CPU (4 requests, 225-frame prompts, 24 frames); with
              the switch on against off, VALL-F's prefill hidden states
              and a NAR pass's logits within 1e-5 of the largest entry,
              B6 launched as counted; a post-norm prenet VALL-E (running
              statistics from a seed): bf16 and lanes (+ flash NAR),
              grouped and per_sample give exact's codes, int8 agrees with
              the plain int8 path on the CPU on >= 98%, and every fused
              mode raises the error that names it. (b) bf16, full width:
              VALL-F, 8 requests with 225-frame prompts and 150 frames
              through the Synthesizer with the switch on (NAR einsum, fp32
              scores; it runs "exact"): B6 launches equal the count from
              the shapes (``vallf_b6_count``: 12 prefill + 7 x 12 NAR with
              text under 128 keys); the post-norm prenet VALL-E in exact,
              int8, bf16 and lanes (each mode's kernel and B4's forward in
              the NAR passes launched) and valle_ar_decode grouped (B 8)
              and per_sample (B 6), 150 frames, 12 launches a step. Wall
              seconds and frames/s of each run. (c) bf16, full width,
              dropout 0.1: 3 steps each of VALL-F (einsum) and of the
              post-norm prenet VALL-E (B4/B5, launches as counted) in
              stage 1 (AR recipe, remat full) and stage 2 (NAR recipe,
              remat none): finite losses, the statistics of the stage's
              prenet alone move, a validation pass moves none; the
              trainer CLI, 2 VALL-F steps of stage 1 to epoch-1.pt, and
              ``bin/infer.py`` on it, plainly and with ``--continual
              true`` (113 frames). Phase 7's seconds are printed.
8. Transformer TTS and the tools (after phase 7; ~90 s).
              (a) fp32, TF32 off, d 1024, 16 heads, 2 layers, 100 mel
              bins, seeded weights (the stop head's bias at -30, so the
              lanes stop by the length rule), every scaling_xformers x
              norm_first setting: the deterministic loss and metrics on
              the card equal the port's on the CPU (1e-5 relative), the
              greedy inference mel at B 4 within 1e-4 of the largest
              entry with equal lens (one lane stops at frame 21); with
              the switch on against off at text 160 and 200 frames, the
              loss and an inference mel within 1e-5, B6 launched 6 times
              a forward (2 layers x encoder, decoder self- and cross-
              attention) and twice an inference (the encoder). (b) bf16,
              12 + 12 layers (352M parameters): ``inference`` at B 8,
              text 160, 200 frames, switch on, B6 launched 12 times, wall
              seconds and frames/s; the trainer CLI (``--model-name
              transformer``) 3 steps on an in-memory fbank corpus with a
              validation pass under the switch, B6 launched 36 times a
              validation batch; ``transformer_visualize_outputs`` and
              ``valle_visualize_outputs`` on the card (finite, shaped).
              (c) the tokenizer's batch extraction (``bin/tokenizer.py
              encode_cuts``) of 8 seeded 3 s wavs on the card against the
              CPU: EnCodec codes equal on >= 98% of frames, fbank features
              within 1e-4; ``bin/verify_encodec.py`` on the seeded codec
              runs its five checks and exits 1 (the SNR check fails on
              random weights); ``bin/export_torch.py`` of (b)'s epoch-1.pt
              loads back in ``models.load_model`` with equal weights.
9. serving over several devices and the recipe (after phase 8; ~2-3
              min). A mesh of two shards (``parallel.mesh.make_mesh``):
              two cards where there are, else cuda:0 twice (each shard
              its thread, stream and, per card, model replica); which it
              ran is printed with the card's name and power limit.
              (a) fp32 greedy, full width, 16 requests (8 rows a shard):
              the mesh Synthesizer's codes equal mesh=None's in "exact",
              "fused" and "mega", "int8" agrees on >= 98% of codes, each
              mode's kernels launch on both shards; sampled "exact"
              (top_k 5) equals mesh=None's; the mesh ContinuousBatcher
              (slots 8, 4 a shard) gives mesh=None's results for 24
              mixed-length requests. (b) bf16: 16 requests with 225-frame
              prompts through the mesh Synthesizer in "fused", and 24
              through the mesh ContinuousBatcher, each beside mesh=None
              in turns, 3 runs each (median and spread), B1/B2 and the
              NAR's B4 launched on both shards. (c) ``serve --dp``: on one
              card ``--dp 1`` through the CLI answers, ``--dp 2`` is
              refused, and a two-shard Synthesizer behind ``make_server``
              answers 4 concurrent requests; on two cards ``--dp 2``
              through the CLI. (d) ``egs/libritts/run_torch.sh`` with
              ``device=cuda``, stages 1-6, on a seeded synthetic LibriTTS
              corpus with a 1-layer, width-64 model and 3 steps a stage
              (where the card machine has no h5py, the recipe's feature
              store goes through a pickle stand-in for h5py's File), in
              a subprocess beside (a) and (c), joined before (b)'s
              timings.

Entries of the kernels line named "<kernel>@dh128" are the kernels at
head dim 128 (d_model 1024 with 8 heads), timed as their Dh-64 entries.
Each entry's "launches" counts its timed bf16 instance on a driven path,
and "launches_from" names that path: the trainer CLI (5e, 5f and every
rank of 5g) for the flash pair, plus the ContinuousBatcher's NAR passes
(6b) for the forward (its Dh-128 entries: the bf16 train steps of 5c), a
switch-on Synthesizer batch and a switch-on ContinuousBatcher run (6b)
for flash_attention, and this script's bf16 checks for
flash_attention_lens, which no path calls. Phase 7 adds its post-norm
prenet model's launches (the decode kernels, B8/B9, B4 in the NAR passes,
B4/B5 in its train steps) and VALL-F's B6 launches; phase 8 the
Transformer TTS's B6 launches (its bf16 inference and the trainer's
validation); phase 9 its bf16 mesh runs' launches (9b's Synthesizer and
ContinuousBatcher runs, both shards; 9a's fp32 launches by shard go to
chip_smoke.json).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/ when that
directory can be written.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FP32_LIMIT = 1e-4   # relative max-abs error vs the plain version, fp32
BF16_LIMIT = 2e-2   # the same at bf16
FP32_ATTN_LIMIT = 2e-5   # absolute max-abs error of B6-B9 at fp32
HBM_BYTES_PER_S = 3.35e12    # H100 SXM peaks (NVIDIA data sheet, 700 W)
BF16_FLOPS = 989e12

KERNELS = {
    "fused_ln_qkv": ("valle_tpu_torch/csrc/fused_dense.cu",
                     "valle_tpu/ops/fused_dense.py:114"),
    "fused_tail": ("valle_tpu_torch/csrc/fused_dense.cu",
                   "valle_tpu/ops/fused_dense.py:201"),
    "flash_mha_fwd": ("valle_tpu_torch/csrc/flash_mha_fwd.cu",
                      "valle_tpu/ops/flash_mha.py:114"),
    "flash_mha_bwd": ("valle_tpu_torch/csrc/flash_mha_bwd.cu",
                      "valle_tpu/ops/flash_mha.py:157"),
    "decode_attention_int8_grouped": (
        "valle_tpu_torch/csrc/decode_attention_int8.cu",
        "valle_tpu/ops/decode_attention_int8_grouped.py:229"),
    "decode_attention_kv": ("valle_tpu_torch/csrc/decode_attention.cu",
                            "valle_tpu/ops/decode_attention_kv.py:220"),
    "decode_attention_lanes": ("valle_tpu_torch/csrc/decode_attention.cu",
                               "valle_tpu/ops/decode_attention_lanes.py:208"),
    "fused_attn_tail": ("valle_tpu_torch/csrc/fused_attn_tail.cu",
                        "valle_tpu/ops/fused_attn_tail.py:324"),
    "flash_attention": ("valle_tpu_torch/csrc/flash_attention.cu",
                        "valle_tpu/ops/attention.py:98"),
    "flash_attention_lens": ("valle_tpu_torch/csrc/flash_attention.cu",
                             "valle_tpu/ops/attention.py:255"),
    "decode_attention": ("valle_tpu_torch/csrc/decode_attention_t.cu",
                         "valle_tpu/ops/decode_attention.py:150"),
    "decode_attention_grouped": (
        "valle_tpu_torch/csrc/decode_attention_t.cu",
        "valle_tpu/ops/decode_attention_grouped.py:171"),
}
# kernels also checked and timed at head dim 128 (d_model 1024 with 8
# heads): their entries on the kernels line are named "<kernel>@dh128"
DH128 = dict(H=8, Dh=128)
DH128_MODEL = dict(nhead=8, num_layers=2)   # d_model 1024: Dh 128
DH128_KERNELS = ("flash_mha_fwd", "flash_mha_bwd", "flash_attention",
                 "flash_attention_lens", "decode_attention",
                 "decode_attention_grouped", "fused_attn_tail",
                 "decode_attention_int8_grouped")
INFERENCE_KERNELS = ("fused_ln_qkv", "fused_tail", "flash_mha_fwd")
DECODE_KERNELS = ("decode_attention_int8_grouped", "decode_attention_kv",
                  "decode_attention_lanes", "fused_attn_tail")
# the kernels each attention-kernel decode mode must launch
MODE_KERNELS = {
    "int8": ("decode_attention_int8_grouped",),
    "fused_int8": ("fused_ln_qkv", "decode_attention_int8_grouped",
                   "fused_tail"),
    "bf16": ("decode_attention_kv",),
    "fused_kv": ("fused_ln_qkv", "decode_attention_kv", "fused_tail"),
    "lanes": ("decode_attention_lanes",),
    "fused_lanes": ("fused_ln_qkv", "decode_attention_lanes", "fused_tail"),
    "mega": ("fused_ln_qkv", "fused_attn_tail"),
}
ALL_DECODE_MODES = ("exact", "unroll", "fused", "fused_w8", "int8",
                    "fused_int8", "bf16", "fused_kv", "lanes", "fused_lanes",
                    "mega", "grouped", "per_sample")
# valle_ar_decode's transposed-cache modes: (mode, batch, kernel)
TRANSPOSED_RUNS = (("grouped", 32, "decode_attention_grouped"),
                   ("per_sample", 6, "decode_attention"))
# kernel-name fragments of each class in a trace's device-time breakdown
KERNEL_CLASSES = (("port kernels", ("flash_", "dense_", "ln_rows",
                                    "decode_attention", "attn_outproj",
                                    "tail_combine")),
                  ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "gemv")),
                  ("elementwise", ("elementwise",)),
                  ("reduction", ("reduce",)))


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def log_phase(name):
    """A phase's header, with the seconds since the script started."""
    log(f"{name} (t {time.perf_counter() - T_START:.1f} s)")


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


def trace_kernels(fn, iters=5, attempts=3):
    """The kernel events of ``iters`` calls of fn, in launch order, from a
    torch.profiler trace. A trace can miss the kernels of its first
    milliseconds, so fn runs for 50 ms first and only the kernels between
    two marker kernels (``torch.cuda._sleep``) around the counted calls
    are kept. CUPTI can drop records, most likely in a process's first
    trace; a trace that lost a marker holds no window to count in, so it
    is logged and traced again, up to ``attempts`` traces in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    path = Path("chiprun_out") / "trace_timing.json"
    path.parent.mkdir(exist_ok=True)
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm_until = time.perf_counter() + 0.05
            while time.perf_counter() < warm_until:
                fn()
                torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        path.unlink()   # large; the sums are what is kept
        kernels = [e for e in events
                   if e.get("cat") == "kernel" and "dur" in e]
        marks = sorted((e for e in kernels if "spin_kernel" in e["name"]),
                       key=lambda e: e["ts"])
        if len(marks) >= 2:
            break
        log(f"  trace {attempt} of {attempts} lost its marker kernels "
            f"({len(marks)} markers among {len(kernels)} kernel events)")
    else:
        raise RuntimeError(f"the trace lost its marker kernels in "
                           f"{attempts} traces")
    lo, hi = marks[-2]["ts"] + marks[-2]["dur"], marks[-1]["ts"]
    return sorted((e for e in kernels if lo <= e["ts"] <= hi
                   and "spin_kernel" not in e["name"]),
                  key=lambda e: e["ts"])


def traced_ms(fn, iters=5, label=None):
    """Device ms per fn() for calls that cannot be graph-captured (autograd
    inside): the kernels' durations in a trace of ``iters`` calls
    (``trace_kernels``), summed (one stream: they do not overlap) and
    divided by ``iters``. The host's speed and waits do not enter. With
    ``label``, logs each kernel's name, launches per call and ms per
    call."""
    kernels = trace_kernels(fn, iters)
    total = sum(e["dur"] for e in kernels)
    if total == 0:
        raise RuntimeError("the trace holds no kernel: no device time")
    if label:
        by_name = {}
        for e in kernels:
            n, d = by_name.get(e["name"][:60], (0, 0.0))
            by_name[e["name"][:60]] = (n + 1, d + e["dur"])
        log(f"  {label}: " + "; ".join(
            f"{name} x{n / iters:g} {d / 1e3 / iters:.4f} ms"
            for name, (n, d) in by_name.items()))
    return total / 1e3 / iters


def kernel_split(fn, iters=20):
    """Device ms a call of fn by kernel name (template arguments kept), in
    launch order, from a trace of ``iters`` calls (``trace_kernels``). A
    kernel launched with programmatic dependent launch starts before its
    predecessor ends, so its time includes that wait."""
    split = {}
    for e in trace_kernels(fn, iters):
        # "void (anonymous namespace)::name<...>(args)"
        kn = e["name"].replace("(anonymous namespace)::", "")
        kn = kn.removeprefix("void ").split("(")[0][:60]
        split[kn] = split.get(kn, 0.0) + e["dur"] / 1e3 / iters
    return split


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


def compare(name, got, ref, limit, errs, absolute=False):
    """Fail unless the max-abs error of got vs ref, relative to ref's
    largest entry (or absolute), is within ``limit``."""
    got, ref = got.float(), ref.float()
    if not bool(torch_isfinite(got)):
        raise RuntimeError(f"{name}: non-finite kernel output")
    abs_err = (got - ref).abs().max().item()
    rel = abs_err / max(ref.abs().max().item(), 1e-30)
    err = abs_err if absolute else rel
    ok = err <= limit
    log(f"  {name}: max_abs={abs_err:.3e} rel={rel:.3e} limit={limit:g}"
        f"{' (absolute)' if absolute else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: error {err:.3e} > {limit:g}")
    errs.append(abs_err)


def same_bits(name, a, b):
    """Fail unless two launches' outputs are equal bit for bit."""
    import torch

    ok = torch.equal(a, b)
    log(f"  {name}: two launches {'bit-equal' if ok else 'DIFFER'}")
    if not ok:
        raise RuntimeError(f"{name}: two launches differ")


def attn_limit(dt):
    """(limit, absolute) of the attention kernels B6-B9 at dtype dt."""
    import torch

    return ((FP32_ATTN_LIMIT, True) if dt == torch.float32
            else (BF16_LIMIT, False))


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
    for B in (1, 8, 32, 65):
        for dt, int8 in ((torch.float32, False), (torch.float32, True),
                         (torch.bfloat16, False), (torch.bfloat16, True)):
            limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
            p = dense_inputs(B, D, F, dt, gen)
            w = dense_weights(p, dt, int8)
            tag = f"B{B} {str(dt)[6:]} w{'int8' if int8 else str(dt)[6:]}"
            qkv = (p["h"], p["ln_w"], p["ln_b"], w["in_w"], p["in_b"])
            got = fd.fused_ln_qkv(*qkv, w_scale=w["in_w_s"])
            ref = fd.fused_ln_qkv_plain(*qkv, w_scale=w["in_w_s"])
            compare(f"fused_ln_qkv {tag}", got, ref, limit,
                    errs["fused_ln_qkv"])
            same = torch.equal(got, fd.fused_ln_qkv(*qkv,
                                                    w_scale=w["in_w_s"]))
            for act in (("relu", "gelu") if B == 8 else ("relu",)):
                args = (p["a"], p["h"], w["out_w"], p["out_b"], p["ln_w"],
                        p["ln_b"], w["w1"], p["b1"], w["w2"], p["b2"])
                sc = ((w["out_w_s"], w["w1_s"], w["w2_s"]) if int8 else None)
                got = fd.fused_tail(*args, activation=act, w_scales=sc)
                ref = fd.fused_tail_plain(*args, activation=act, w_scales=sc)
                compare(f"fused_tail {tag} {act}", got, ref, limit,
                        errs["fused_tail"])
                same &= torch.equal(got, fd.fused_tail(
                    *args, activation=act, w_scales=sc))
            if not same:
                raise RuntimeError(f"dense kernels {tag}: two launches "
                                   "gave different bits")
    log("  dense kernels: two launches bit-equal at every shape above")

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


DEC = dict(B=32, H=16, Dh=64, T=512, S=64)    # the bench attention shape


def decode_inputs(dt, gen, spread=True, H=DEC["H"], Dh=DEC["Dh"]):
    """q, k, v at DEC's shape (or H heads of Dh). Spread lengths: x_len in
    [1, S], write_pos in [S, T), row 0 reading the whole cache and row 1
    only its first audio key; else the bench rows' mean step (x_len 64,
    write_pos 64 + 225 + 75, 365 valid keys). Lengths are int32, as the AR
    loop passes them (a timed call then holds no cast kernel)."""
    import torch

    B, T, S = (DEC[k] for k in ("B", "T", "S"))
    q, k, v = (torch.randn(B, H, n, Dh, generator=gen, device="cuda").to(dt)
               for n in (1, T, T))
    i32 = dict(dtype=torch.int32, device="cuda")
    if spread:
        x_lens = torch.randint(1, S + 1, (B,), generator=gen, **i32)
        wp = torch.randint(S, T, (B,), generator=gen, **i32)
        x_lens[0], wp[0], wp[1] = S, T - 1, S
    else:
        x_lens = torch.full((B,), S, **i32)
        wp = torch.full((B,), S + 225 + 75, **i32)
    return q, k, v, x_lens, wp


def decode_caches(k, v):
    from valle_tpu_torch.modules.transformer import quantize_kv
    from valle_tpu_torch.ops import decode_attention_int8_grouped as d8
    from valle_tpu_torch.ops import decode_attention_kv as dkv
    from valle_tpu_torch.ops import decode_attention_lanes as dln

    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"int8": (d8.combine_kv_int8(kq, vq), d8.stack_scales(ks, vs)),
            "kv": dkv.combine_kv(k, v), "lanes": dln.combine_kv_lanes(k, v)}


def decode_calls(q, caches, x_lens, wp):
    """{name: (kernel call, plain call)} of the three decode kernels."""
    from valle_tpu_torch.ops import decode_attention_int8_grouped as d8
    from valle_tpu_torch.ops import decode_attention_kv as dkv
    from valle_tpu_torch.ops import decode_attention_lanes as dln

    S, H = DEC["S"], q.shape[1]
    i8 = caches["int8"]
    return {
        "decode_attention_int8_grouped": (
            lambda: d8.decode_attention_int8_grouped(q, *i8, x_lens, wp, S=S),
            lambda: d8.decode_attention_int8_grouped_plain(q, *i8, x_lens,
                                                           wp, S=S)),
        "decode_attention_kv": (
            lambda: dkv.decode_attention_kv(q, caches["kv"], x_lens, wp, S=S),
            lambda: dkv.decode_attention_kv_plain(q, caches["kv"], x_lens,
                                                  wp, S=S)),
        "decode_attention_lanes": (
            lambda: dln.decode_attention_lanes(q, caches["lanes"], x_lens,
                                               wp, S=S, nhead=H),
            lambda: dln.decode_attention_lanes_plain(q, caches["lanes"],
                                                     x_lens, wp, S=S,
                                                     nhead=H)),
    }


def attn_tail_args(q, lanes, x_lens, wp, p, dt):
    """fused_attn_tail's operands, every parameter in dt as a model in dt
    passes them (no cast kernels in a timed call)."""
    w = dense_weights(p, dt, False)
    v = {n: p[n].to(dt) for n in ("out_b", "ln_w", "ln_b", "b1", "b2")}
    return (q, p["h"], lanes, x_lens, wp, w["out_w"], v["out_b"], v["ln_w"],
            v["ln_b"], w["w1"], v["b1"], w["w2"], v["b2"])


def check_decode_kernels(errs):
    """The decode-attention kernels and fused_attn_tail against their plain
    versions at the bench attention shape, fp32 and bf16; the aligned
    prompts' scalar write_pos too."""
    import torch

    from valle_tpu_torch.ops import fused_attn_tail as fat

    gen = torch.Generator("cuda").manual_seed(11)
    Fd = 4096
    # the bench heads, and Dh 128 (d_model 1024 with 8 heads)
    for dt, H, Dh in ((torch.float32, DEC["H"], DEC["Dh"]),
                      (torch.bfloat16, DEC["H"], DEC["Dh"]),
                      (torch.float32, 8, 128), (torch.bfloat16, 8, 128)):
        limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
        q, k, v, x_lens, wp = decode_inputs(dt, gen, H=H, Dh=Dh)
        caches = decode_caches(k, v)
        tag = f"{str(dt)[6:]} Dh {Dh}"
        for w, wtag in ((wp, "per-row write_pos"), (wp[2], "scalar")):
            for name, (kern, plain) in decode_calls(q, caches, x_lens,
                                                    w).items():
                ekey = name
                if name == "decode_attention_int8_grouped" and Dh == 128:
                    ekey = name + "@dh128"
                got = kern()
                compare(f"{name} {tag} {wtag}", got, plain(), limit,
                        errs[ekey])
                if name == "decode_attention_int8_grouped":
                    same_bits(f"{name} {tag} {wtag}", got, kern())
        p = dense_inputs(DEC["B"], H * Dh, Fd, dt, gen)
        args = attn_tail_args(q, caches["lanes"], x_lens, wp, p, dt)
        key = "fused_attn_tail" + ("" if Dh == DEC["Dh"] else "@dh128")
        for act in ("relu", "gelu"):
            got = fat.fused_attn_tail(*args, S=DEC["S"], activation=act)
            compare(f"fused_attn_tail {tag} {act}", got,
                    fat.fused_attn_tail_plain(*args, S=DEC["S"],
                                              activation=act),
                    limit, errs[key])
            same_bits(f"fused_attn_tail {tag} {act}", got,
                      fat.fused_attn_tail(*args, S=DEC["S"],
                                          activation=act))
    torch.cuda.synchronize()


# B3's edge cases (B, T, S), as in tests/test_torch_port_cuda.py (the
# bench step is check_decode_kernels')
INT8_EDGES = {"x_len_0": (5, 384, 40), "whole_cache": (4, 384, 40),
              "ragged_ends": (6, 1024, 61), "one_row": (1, 512, 64),
              "long_cache": (3, 2048, 64)}


def check_int8_edges(errs):
    """decode_attention_int8_grouped at the edges of its bulk-copied key
    runs, at the bench heads (H 16, Dh 64) and at Dh 128 (H 8), fp32 and
    bf16, per-row and scalar write_pos, two launches bit-equal: no text
    key (x_len 0; row 0's only key its first audio key), the whole cache
    (x_len = S, write_pos = T - 1), runs ending off multiples of 4 keys
    and of the 128-key chunk (S 61), one row, a 2048-row cache."""
    import torch

    from valle_tpu_torch.ops import decode_attention_int8_grouped as d8

    gen = torch.Generator("cuda").manual_seed(17)
    name = "decode_attention_int8_grouped"
    i32 = dict(dtype=torch.int32, device="cuda")
    for dt, H, Dh in ((torch.float32, 16, 64), (torch.bfloat16, 16, 64),
                      (torch.float32, 8, 128), (torch.bfloat16, 8, 128)):
        limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
        ekey = name + ("@dh128" if Dh == 128 else "")
        for case, (B, T, S) in INT8_EDGES.items():
            q, k, v = (torch.randn(B, H, n, Dh, generator=gen,
                                   device="cuda").to(dt) for n in (1, T, T))
            x_lens = torch.randint(0, S + 1, (B,), generator=gen, **i32)
            wp = torch.randint(S, T, (B,), generator=gen, **i32)
            if case == "x_len_0":
                x_lens[:] = 0
                wp[0], wp[1] = S, T - 1
            elif case == "whole_cache":
                x_lens[:], wp[:] = S, T - 1
            elif case == "ragged_ends":
                x_lens[:3] = torch.tensor((S, 1, 7), **i32)
                wp[:3] = torch.tensor((T - 2, S + 130, S + 253), **i32)
            elif case == "one_row":
                x_lens[0], wp[0] = 37, S + 300
            i8 = decode_caches(k, v)["int8"]
            for w, wtag in ((wp, "per-row"), (wp[0], "scalar")):
                got = d8.decode_attention_int8_grouped(q, *i8, x_lens, w,
                                                       S=S)
                tag = f"{name} {case} {str(dt)[6:]} Dh {Dh} {wtag}"
                compare(tag, got, d8.decode_attention_int8_grouped_plain(
                    q, *i8, x_lens, w, S=S), limit, errs[ekey])
                same_bits(tag, got, d8.decode_attention_int8_grouped(
                    q, *i8, x_lens, w, S=S))
    torch.cuda.synchronize()


PREFILL = dict(B=8, H=16, Dh=64, S_text=64, P=225, G=150)  # AR prefill/NAR


def attn_views(B, T, H, Dh, dt, gen):
    """q, k, v (B, H, T, Dh) as the stacks pass them: strided views of one
    fused in-projection output (B, T, 3 H Dh)."""
    import torch

    from valle_tpu_torch.modules.transformer import split_qkv

    x = torch.randn(B, T, 3 * H * Dh, generator=gen, device="cuda")
    return split_qkv(x.to(dt), H)


def attn_lengths(gen):
    """Spread text, prompt and generated lengths of PREFILL's rows; row 0
    full."""
    import torch

    B, St, P, G = (PREFILL[k] for k in ("B", "S_text", "P", "G"))
    lens = [torch.randint(n // 2, n + 1, (B,), generator=gen, device="cuda")
            for n in (St, P, G)]
    for x, n in zip(lens, (St, P, G)):
        x[0] = n
    return lens


def attn_bias(shape, gen):
    """(T, bias): the AR prefill's composite bias (B, 1, T, T) over [text;
    prompt], or the NAR passes' key bias (B, 1, 1, T) over [text; prompt;
    generated] (models/inference.py valle_nar_decode); -inf where
    masked."""
    import torch

    from valle_tpu_torch.ops import masks as M

    St, P, G = (PREFILL[k] for k in ("S_text", "P", "G"))
    x_lens, p_lens, g_lens = attn_lengths(gen)
    if shape == "prefill":
        return St + P, M.ar_xy_attn_bias(x_lens, p_lens, St, P)
    T = St + P + G
    kk = torch.arange(T, device="cuda")[None, :]
    valid = torch.where(kk < St, kk < x_lens[:, None], torch.where(
        kk < St + P, kk - St < p_lens[:, None], kk - St - P < g_lens[:, None]))
    bias = torch.zeros(valid.shape, device="cuda").masked_fill(
        ~valid, float("-inf"))
    return T, bias[:, None, None, :]


def lens_case(causal, gen, skipping=False):
    """(T, x_lens, y_lens, plain bias) of flash_attention_lens at the
    prefill (causal) or NAR (padding) shape. ``skipping``: lengths whose
    key tiles the kernel skips (x_len < 64, y_len 0) and a row with no
    text (under the causal mask its text queries see no key)."""
    import torch

    from valle_tpu_torch.ops import attention as pa

    St, P, G = (PREFILL[k] for k in ("S_text", "P", "G"))
    x_lens, p_lens, g_lens = attn_lengths(gen)
    T = St + P + (0 if causal else G)
    y_lens = p_lens if causal else p_lens + g_lens
    if skipping:
        x_lens = torch.tensor([St, 20, 1, 0, 40, 63, 5, 33], device="cuda")
        y_lens = torch.tensor([T - St, 100, 0, 5, 64, 1, 150, 0],
                              device="cuda")
    return T, x_lens, y_lens, pa._clamp(pa._lens_bias(x_lens, y_lens, St,
                                                      causal, T, T))


def lens_skipped_share(x_lens, y_lens, St, causal, T, tile=64):
    """Share of (query tile, key tile) pairs of 64 x 64 (S = T) that
    flash_attention_lens skips: no query of the tile sees a key of the
    other (csrc/flash_fwd.cuh build_lens_list), from the lengths."""
    n = -(-T // tile)
    skipped = 0
    for x, y in zip(x_lens.tolist(), y_lens.tolist()):
        text_end = min(St, x, T)
        for qt in range(n):
            audio_end = min(T, St + max(y, 0))
            if causal:
                audio_end = min(audio_end, min((qt + 1) * tile, T))
            for kt in range(n):
                t0 = kt * tile
                seen = t0 < text_end or max(t0, St) < min(t0 + tile,
                                                          audio_end)
                skipped += not seen
    return skipped / (len(x_lens.tolist()) * n * n)


def check_attention_kernels(errs, info):
    """B6/B7 at the AR prefill and NAR-pass shapes, Dh 128 with odd S/T
    and a fully masked row, B6's gradient; B8/B9 at the bench step. B7's
    bf16 launches here, at Dh 64 and at Dh 128, are its counts on the
    kernels line: no path calls it (as in the JAX package)."""
    import torch

    from valle_tpu_torch.ops import attention as pa
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import decode_attention as dt8
    from valle_tpu_torch.ops import decode_attention_grouped as dt9

    gen = torch.Generator("cuda").manual_seed(13)
    B, H, Dh, St = (PREFILL[k] for k in ("B", "H", "Dh", "S_text"))
    Hh, Dd = DH128["H"], DH128["Dh"]
    lens_bf16 = {"flash_attention_lens": 0, "flash_attention_lens@dh128": 0}

    def check_lens(dt, H_, D_, causal, skipping, key):
        """B7 against its plain version, launched twice bit for bit."""
        lim, ab = attn_limit(dt)
        T, x_lens, y_lens, lb = lens_case(causal, gen, skipping)
        q, k, v = attn_views(B, T, H_, D_, dt, gen)
        tag = (f"flash_attention_lens {str(dt)[6:]} Dh {D_} "
               f"{'AR causal' if causal else 'NAR padding'} S=T={T}"
               f"{', skipped tiles' if skipping else ''}")
        before = cb.LAUNCHES["flash_attention_lens"]
        got = pa.flash_attention_lens(q, k, v, x_lens, y_lens, St, causal)
        compare(tag, got, pa.naive_attention(q, k, v, lb), lim, errs[key],
                absolute=ab)
        same_bits(tag, got, pa.flash_attention_lens(q, k, v, x_lens, y_lens,
                                                    St, causal))
        if dt == torch.bfloat16:
            lens_bf16[key] += cb.LAUNCHES["flash_attention_lens"] - before
        if skipping:
            share = lens_skipped_share(x_lens, y_lens, St, causal, T)
            log(f"    key tiles skipped: {share:.3f}")

    for dt in (torch.float32, torch.bfloat16):
        lim, ab = attn_limit(dt)
        tg = str(dt)[6:]
        for shape in ("prefill", "nar"):
            T, bias = attn_bias(shape, gen)
            q, k, v = attn_views(B, T, H, Dh, dt, gen)
            compare(f"flash_attention {tg} {shape} S=T={T} bias "
                    f"{tuple(bias.shape)}", pa.flash_attention(q, k, v, bias),
                    pa.naive_attention(q, k, v, pa._clamp(bias)), lim,
                    errs["flash_attention"], absolute=ab)
        for causal in (True, False):
            check_lens(dt, H, Dh, causal, False, "flash_attention_lens")
        # Dh 128, S 200 / T 333, row 5 of sample 0 fully masked
        q = attn_views(2, 200, 4, 128, dt, gen)[0]
        _, k, v = attn_views(2, 333, 4, 128, dt, gen)
        bias = torch.zeros(2, 1, 200, 333, device="cuda")
        bias[1, :, :, 250:] = float("-inf")
        bias[0, :, 5] = float("-inf")
        got = pa.flash_attention(q, k, v, bias)
        compare(f"flash_attention {tg} Dh 128 S 200 T 333, a fully masked "
                "row", got, pa.naive_attention(q, k, v, pa._clamp(bias)),
                lim, errs["flash_attention"], absolute=ab)
    # the gradient: kernel forward, plain recompute backward, fp32
    T, bias = attn_bias("prefill", gen)
    qkv = [x.detach().requires_grad_()
           for x in attn_views(B, T, H, Dh, torch.float32, gen)]
    g = torch.randn(B, H, T, Dh, generator=gen, device="cuda")
    out = pa.flash_attention(*qkv, bias)
    grads = torch.autograd.grad(out, qkv, g)
    ref_grads = torch.autograd.grad(
        pa.naive_attention(*qkv, pa._clamp(bias)), qkv, g)
    for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        compare(f"flash_attention grad {n} fp32 prefill", a, b, FP32_LIMIT,
                [])

    # B7 where whole key tiles are skipped, then B6/B7 at Dh 128 (8 heads)
    # at both shapes; each kernel launched twice, bit for bit
    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            check_lens(dt, H, Dh, causal, True, "flash_attention_lens")
    for dt in (torch.float32, torch.bfloat16):
        lim, ab = attn_limit(dt)
        tg = str(dt)[6:]
        for shape in ("prefill", "nar"):
            T, bias = attn_bias(shape, gen)
            q, k, v = attn_views(B, T, Hh, Dd, dt, gen)
            got = pa.flash_attention(q, k, v, bias)
            compare(f"flash_attention {tg} Dh 128 {shape} S=T={T} bias "
                    f"{tuple(bias.shape)}", got,
                    pa.naive_attention(q, k, v, pa._clamp(bias)), lim,
                    errs["flash_attention@dh128"], absolute=ab)
            same_bits(f"flash_attention {tg} Dh 128 {shape}", got,
                      pa.flash_attention(q, k, v, bias))
        for causal in (True, False):
            for skipping in (False, True):
                check_lens(dt, Hh, Dd, causal, skipping,
                           "flash_attention_lens@dh128")
    info["flash_attention_lens_bf16_check_launches"] = lens_bf16

    S = DEC["S"]
    for H_, D_ in ((DEC["H"], DEC["Dh"]), (Hh, Dd)):
        sfx = "" if D_ == DEC["Dh"] else "@dh128"
        for dt in (torch.float32, torch.bfloat16):
            lim, ab = attn_limit(dt)
            q, k, v, x_lens, wp = decode_inputs(dt, gen, H=H_, Dh=D_)
            kt, vt = (x.transpose(-1, -2).contiguous() for x in (k, v))
            for w, wtag in ((wp, "per-row write_pos"), (wp[2], "scalar")):
                for nb in (DEC["B"], 6):
                    a = (q[:nb], kt[:nb], vt[:nb], x_lens[:nb],
                         w[:nb] if w.dim() else w)
                    ref = dt8.decode_attention_plain(*a, S=S)
                    tag = f"{str(dt)[6:]} Dh {D_} B {nb} {wtag}"
                    got = dt8.decode_attention(*a, S=S)
                    compare(f"decode_attention {tag}", got, ref, lim,
                            errs["decode_attention" + sfx], absolute=ab)
                    same_bits(f"decode_attention {tag}", got,
                              dt8.decode_attention(*a, S=S))
                    if nb % 8 == 0:
                        compare(f"decode_attention_grouped {tag}",
                                dt9.decode_attention_grouped(*a, S=S), ref,
                                lim, errs["decode_attention_grouped" + sfx],
                                absolute=ab)
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


def build_synth(model, audio_tok, decode_mode, max_gen_len=150, **kw):
    import torch

    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import TextTokenizer
    from valle_tpu_torch.serving import Synthesizer

    symbols = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
    args = dict(top_k=10, max_gen_len=max_gen_len,
                compute_dtype=torch.bfloat16, decode_mode=decode_mode,
                codec_dtype="bfloat16", wav_transfer="pcm16", seed=1,
                device="cuda")
    args.update(kw)
    return Synthesizer(model, TextTokenizer(backend="char"),
                       TextTokenCollater(symbols), audio_tok, **args)


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
    counts_fused = {k: cb.LAUNCHES[k] for k in INFERENCE_KERNELS}
    res4 = synths["fused_w8"].synthesize(reqs[:4], max_gen_len=150)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: cb.LAUNCHES[k] for k in INFERENCE_KERNELS}
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
    info["launches_synthesis"] = launches
    info["e2e_s"] = {"fused_8req": t1 - t0, "fused_w8_4req": t2 - t1}
    return reqs


def run_decode_modes(model, audio_tok, reqs, info):
    """8 requests in "auto" with a 512-frame budget (a cache >= 640 rows:
    the JAX policy's int8), then 8 in each other attention-kernel mode
    with a 64-frame budget; counts set to 0 before each run and read after
    it."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb

    runs, launches = {}, {}
    for mode, budget in (("auto", 512), ("fused_int8", 64), ("bf16", 64),
                         ("fused_kv", 64), ("lanes", 64),
                         ("fused_lanes", 64), ("mega", 64)):
        synth = build_synth(model, audio_tok, mode, max_gen_len=budget)
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        res = synth.synthesize(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(cb.LAUNCHES)
        ran = synth.last_decode_mode
        log(f"  {mode} 8 requests, budget {budget}: ran {ran!r}, "
            f"{dt:.3f} s, frames {[r.frames for r in res]}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        check_results(res, 8)
        want = "int8" if mode == "auto" else mode
        if ran != want:
            raise RuntimeError(f"decode mode {mode!r} ran {ran!r}, "
                               f"expected {want!r}")
        for k in MODE_KERNELS[want] + ("flash_mha_fwd",):
            if counts[k] <= 0:
                raise RuntimeError(f"{k} never launched in the {mode} run")
        runs[mode] = {"ran": ran, "s": dt, "frames": [r.frames for r in res]}
        launches[mode] = counts
    info["decode_mode_runs"] = runs
    info["launches_decode_modes"] = launches
    return launches


def check_reference(model32, info, key="",
                    modes=("fused", "bf16", "fused_kv", "lanes",
                           "fused_lanes", "mega"),
                    int8_modes=("int8", "fused_int8")):
    """fp32, greedy, B 8: the token-exact kernel ``modes`` (and "grouped"
    and "per_sample" through valle_ar_decode) give the codes of the plain
    "exact" path; ``int8_modes`` through the kernels agree with the plain
    int8 path (the port's plain versions, on the CPU) on >= 98% of AR
    codes with equal lengths. Results go to info["fp32_reference" +
    key]."""
    import torch

    from valle_tpu_torch.models.inference import (valle_ar_decode,
                                                  valle_inference)

    gen = torch.Generator("cuda").manual_seed(3)
    B, S, P = 8, 32, 64
    text = torch.randint(3, 30, (B, S), generator=gen, device="cuda")
    tl = torch.tensor([32, 20, 5, 32, 17, 28, 9, 32], device="cuda")
    pc = torch.randint(0, 1024, (B, P, 8), generator=gen, device="cuda")
    pl = torch.tensor([64, 50, 64, 33, 60, 64, 41, 57], device="cuda")

    def run(dm, na):
        return valle_inference(model32, text, tl, pc, pl, top_k=1,
                               max_gen_len=24, decode_mode=dm,
                               nar_attn_impl=na)

    base = run("exact", "einsum")
    res = {}
    for dm in modes:
        out = run(dm, "flash")
        same = torch.equal(base[0], out[0]) and torch.equal(base[1], out[1])
        res[dm] = same
        log(f"  fp32 greedy codes{key}, {dm}+flash vs exact+einsum (B 8): "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError(f"{dm}: kernel path codes differ from the "
                               "plain path")
    args = (text, tl, pc[..., 0], pl)
    ar_exact = valle_ar_decode(model32, *args, top_k=1, max_gen_len=24,
                               decode_mode="exact")
    for dm in ("grouped", "per_sample"):
        got = valle_ar_decode(model32, *args, top_k=1, max_gen_len=24,
                              decode_mode=dm)
        same = all(torch.equal(a, b) for a, b in zip(got, ar_exact))
        res[dm] = same
        log(f"  fp32 greedy AR codes{key}, {dm} vs exact (B 8): "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError(f"{dm}: kernel path codes differ from the "
                               "plain path")
    cpu = copy.deepcopy(model32).cpu() if int8_modes else None
    for dm in int8_modes:
        got = valle_ar_decode(model32, *args, top_k=1, max_gen_len=24,
                              decode_mode=dm)
        ref = valle_ar_decode(cpu, *(a.cpu() for a in args), top_k=1,
                              max_gen_len=24, decode_mode=dm)
        share = (got[0].cpu() == ref[0]).float().mean().item()
        same_len = torch.equal(got[1].cpu(), ref[1])
        res[dm] = share
        log(f"  fp32 greedy AR codes, {dm} kernels (cuda) vs plain (cpu): "
            f"{share:.4f} equal, lengths {'equal' if same_len else 'DIFFER'}"
            " (limit 0.98)")
        if share < 0.98 or not same_len:
            raise RuntimeError(f"{dm}: kernel codes agree with the plain "
                               f"int8 path on {share:.4f} < 0.98")
    del cpu
    info["fp32_reference" + key] = res


def check_int8_long(info):
    """fp32, greedy, B 8, full length: "int8" and "fused_int8" through
    the kernels agree with the plain int8 path (the port's plain
    versions, on the CPU) on >= 98% of AR codes over the first 150 and
    all 735 frames of one 735-frame run (cache 1024 rows, up to 7 of B3's
    128-key chunks a row; a step reads only its valid keys, so the first
    150 frames are those of a 150-frame run). On FULL's width with 2
    layers (seeded weights), which keeps the plain run on the CPU short;
    the 24-frame check of ``check_reference`` runs all 12."""
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    t0 = time.perf_counter()
    model = VALLE(ValleConfig(**dict(FULL, num_layers=2)),
                  generator=torch.Generator("cuda").manual_seed(7)).eval()
    cpu = copy.deepcopy(model).cpu()
    gen = torch.Generator("cuda").manual_seed(3)
    B, S, P = 8, 32, 64
    text = torch.randint(3, 30, (B, S), generator=gen, device="cuda")
    tl = torch.tensor([32, 20, 5, 32, 17, 28, 9, 32], device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    pl = torch.tensor([64, 50, 64, 33, 60, 64, 41, 57], device="cuda")
    args = (text, tl, pq, pl)
    res = {}
    for dm in ("int8", "fused_int8"):
        kw = dict(top_k=1, max_gen_len=735, force_full_length=True,
                  decode_mode=dm)
        got = valle_ar_decode(model, *args, **kw)[0].cpu()
        ref = valle_ar_decode(cpu, *(a.cpu() for a in args), **kw)[0]
        for frames in (150, 735):
            share = (got[:, :frames] == ref[:, :frames]).float().mean().item()
            res[f"{dm} {frames}"] = share
            log(f"  fp32 greedy AR codes, {dm} kernels (cuda) vs plain "
                f"(cpu), B 8, 2 layers, {frames} frames: {share:.4f} equal "
                "(limit 0.98)")
            if share < 0.98:
                raise RuntimeError(f"{dm}: kernel codes agree with the "
                                   f"plain int8 path on {share:.4f} < 0.98 "
                                   f"at {frames} frames")
    del cpu, model
    res["seconds"] = time.perf_counter() - t0
    log(f"  the long int8 check took {res['seconds']:.1f} s")
    info["fp32_int8_long"] = res


def flash_switch(on: bool) -> None:
    """Set or clear VALLE_TPU_FLASH_ATTENTION (read at every call)."""
    import os

    if on:
        os.environ["VALLE_TPU_FLASH_ATTENTION"] = "1"
    else:
        os.environ.pop("VALLE_TPU_FLASH_ATTENTION", None)


def check_flash_switch_fp32(model32, info):
    """fp32, full width, B 8: with the switch on (B6 in every attention of
    the prefill and the NAR stack) against off (the plain route), the
    prefill's hidden states and the logits of a NAR pass (stage 1, seeded
    inputs at the NAR shape) within 1e-5 of the largest entry; the share
    of equal greedy codes of the whole synthesis is printed."""
    import torch

    from valle_tpu_torch.models.inference import _frontends, valle_inference
    from valle_tpu_torch.models.valle import nar_predict_weights
    from valle_tpu_torch.modules.transformer import (encoder_stack_apply,
                                                     encoder_stack_prefill)
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import masks as M

    gen = torch.Generator("cuda").manual_seed(14)
    B, St, P = PREFILL["B"], PREFILL["S_text"], PREFILL["P"]
    cfg = model32.cfg
    text = torch.randint(3, 30, (B, St), generator=gen, device="cuda")
    pc = torch.randint(0, 1024, (B, P, 8), generator=gen, device="cuda")
    tl, pl, _ = attn_lengths(gen)
    x, y = _frontends(model32, text, pc[..., 0], torch.float32)
    bias = M.ar_xy_attn_bias(tl, pl, St, P)
    T, nbias = attn_bias("nar", gen)
    seq = torch.randn(B, T, cfg.nar_d_model, generator=gen, device="cuda")
    cond = model32.nar_stage_embeddings[0].word_embeddings.weight
    W = nar_predict_weights(model32)[0]

    def prefill():
        return encoder_stack_prefill(
            model32.ar_decoder, torch.cat([x, y], dim=1), bias,
            cache_len=St + P, activation=cfg.activation,
            dtype=torch.float32)[0]

    def nar_logits():
        hid = encoder_stack_apply(model32.nar_decoder, seq, nbias, cond,
                                  activation=cfg.activation,
                                  dtype=torch.float32)
        return hid[:, -PREFILL["G"]:] @ W.T

    res = {}
    for name, fn, want in (("prefill hidden", prefill, cfg.num_layers),
                           ("NAR pass logits", nar_logits,
                            cfg.nar_num_layers)):
        flash_switch(True)
        cb.reset_launch_counts()
        on = fn()
        n = cb.LAUNCHES["flash_attention"]
        flash_switch(False)
        off = fn()
        rel = ((on - off).abs().max() / off.abs().max()).item()
        log(f"  fp32 {name}, switch on vs off: rel {rel:.3e} (limit 1e-5), "
            f"flash_attention launches {n} (want {want})")
        if rel > 1e-5 or n != want:
            raise RuntimeError(f"flash switch: {name} rel {rel:.3e}, "
                               f"launches {n}")
        res[name] = rel
    codes = {}
    for on in (True, False):
        flash_switch(on)
        codes[on] = valle_inference(model32, text, tl, pc, pl, top_k=1,
                                    max_gen_len=24, decode_mode="exact",
                                    nar_attn_impl="einsum")
    flash_switch(False)
    share = (codes[True][0] == codes[False][0]).float().mean().item()
    same_len = torch.equal(codes[True][1], codes[False][1])
    log(f"  fp32 greedy synthesis codes, switch on vs off (B 8): {share:.4f} "
        f"equal, lengths {'equal' if same_len else 'differ'}")
    res["codes_equal_share"] = share
    res["lengths_equal"] = same_len
    info["flash_switch_fp32"] = res


def run_flash_switch(model, audio_tok, reqs, info):
    """The Synthesizer with the switch on (8 requests, 225-frame prompts,
    150 frames, NAR einsum, fp32 NAR scores, decode mode "fused"): B6 in
    the AR prefill and the 7 NAR passes, 96 launches per batch; then
    seconds per batch on and off in turns (on, off, off, on), and a
    profiler trace of one batch each way."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb

    synth = build_synth(model, audio_tok, "fused", nar_attn_impl="einsum",
                        nar_score_bf16="off")
    L = model.cfg.num_layers + 7 * model.cfg.nar_num_layers
    secs = {True: [], False: []}
    launches = None
    for on in (True, False, False, True):
        flash_switch(on)
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        res = synth.synthesize(reqs, max_gen_len=150)
        torch.cuda.synchronize()
        secs[on].append(time.perf_counter() - t0)
        n = cb.LAUNCHES["flash_attention"]
        check_results(res, 8)
        log(f"  switch {'on ' if on else 'off'} 8 requests: "
            f"{secs[on][-1]:.3f} s, frames {[r.frames for r in res]}, "
            f"flash_attention launches {n}")
        if n != (L if on else 0):
            raise RuntimeError(f"flash switch {on}: {n} flash_attention "
                               f"launches, expected {L if on else 0}")
        if on and launches is None:
            launches = dict(cb.LAUNCHES)
    info["flash_switch_synthesis_s"] = {"on": secs[True], "off": secs[False]}
    for on in (True, False):     # where the seconds go, on and off
        flash_switch(on)
        tag = "on" if on else "off"
        prof = profile_busy(lambda: synth.synthesize(reqs, max_gen_len=150),
                            f"trace_switch_{tag}.json")
        log_busy(f"Synthesizer 8 requests, switch {tag}", prof)
        info[f"flash_switch_{tag}_profile"] = prof
    flash_switch(False)
    return launches


def run_flash_switch_dh128(audio_tok, reqs, info):
    """One Synthesizer batch with the switch on (the 8 requests, decode
    mode "fused", NAR einsum) of a bf16 model at Dh 128 (FULL with 8 heads
    and 2 layers, seeded weights): B6's Dh-128 instance in the prefill and
    the 7 NAR passes. Its launches are the flash_attention@dh128 count."""
    import torch

    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.ops import cuda_build as cb

    model = VALLE(ValleConfig(**dict(FULL, **DH128_MODEL)),
                  generator=torch.Generator("cuda").manual_seed(2))
    model = model.to(torch.bfloat16).eval()
    synth = build_synth(model, audio_tok, "fused", nar_attn_impl="einsum",
                        nar_score_bf16="off")
    want = model.cfg.num_layers + 7 * model.cfg.nar_num_layers
    flash_switch(True)
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res = synth.synthesize(reqs, max_gen_len=150)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    flash_switch(False)
    launches = dict(cb.LAUNCHES)
    check_results(res, 8)
    n = launches["flash_attention"]
    log(f"  switch on, Dh 128 (8 heads, 2 layers), 8 requests: {secs:.3f} "
        f"s, frames {[r.frames for r in res]}, flash_attention launches {n}")
    if n != want:
        raise RuntimeError(f"flash switch at Dh 128: {n} flash_attention "
                           f"launches, expected {want}")
    info["flash_switch_dh128_s"] = secs
    del synth, model
    torch.cuda.empty_cache()
    return launches


def run_transposed_modes(model, info, key=""):
    """valle_ar_decode "grouped" at B 32 and "per_sample" at B 6 (bench
    text 64, prompt 225, 64 frames, bf16): the mode's kernel launched once
    a layer and step; counts set to 0 before each run."""
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode
    from valle_tpu_torch.ops import cuda_build as cb

    gen = torch.Generator("cuda").manual_seed(15)
    S, P, G = 64, 225, 64
    L = model.cfg.num_layers
    launches = {}
    for mode, B, kernel in TRANSPOSED_RUNS:
        text = torch.randint(0, 100, (B, S), generator=gen, device="cuda")
        pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
        n = torch.full((B,), S, device="cuda")
        pl = torch.full((B,), P, device="cuda")
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        codes, lens = valle_ar_decode(model, text, n, pq, pl, generator=gen,
                                      top_k=10, max_gen_len=G,
                                      compute_dtype=torch.bfloat16,
                                      force_full_length=True,
                                      decode_mode=mode)
        torch.cuda.synchronize()
        launches[mode] = dict(cb.LAUNCHES)
        got = launches[mode][kernel]
        log(f"  valle_ar_decode{key} {mode} B {B}, {G} steps: {kernel} "
            "launched "
            f"{got} times ({got / G:g} a step)")
        if got != L * G or not bool((codes >= 0).all()):
            raise RuntimeError(f"{mode}: {kernel} launched {got} times, "
                               f"expected {L * G}")
    info["launches_transposed_modes" + key] = launches
    return launches


def run_dh128_decode_modes(audio_tok, reqs, info):
    """The decode modes of B3, B8, B9 and B12 at Dh 128 (FULL with 8 heads
    and 2 layers, seeded weights): fp32 greedy codes at B 8 of "mega",
    "grouped" and "per_sample" equal "exact"'s; then bf16, 8 Synthesizer
    requests in "mega" and in "int8" (64 frames) and the transposed runs. Returns the
    bf16 runs' launches (counts set to 0 before each run): the
    "<kernel>@dh128" counts."""
    import torch

    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.ops import cuda_build as cb

    model = VALLE(ValleConfig(**dict(FULL, **DH128_MODEL)),
                  generator=torch.Generator("cuda").manual_seed(4)).eval()
    check_reference(model, info, "@dh128", modes=("mega",), int8_modes=())
    model = model.to(torch.bfloat16)
    synth = build_synth(model, audio_tok, "mega", max_gen_len=64)
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    res = synth.synthesize(reqs)
    torch.cuda.synchronize()
    launches = {"mega": dict(cb.LAUNCHES)}
    check_results(res, 8)
    n = launches["mega"]["fused_attn_tail"]
    log(f"  mega, Dh 128 (8 heads, 2 layers), 8 requests: frames "
        f"{[r.frames for r in res]}, fused_attn_tail launches {n}")
    if n <= 0 or synth.last_decode_mode != "mega":
        raise RuntimeError("mega at Dh 128 did not launch fused_attn_tail")
    synth = build_synth(model, audio_tok, "int8", max_gen_len=64)
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    res = synth.synthesize(reqs)
    torch.cuda.synchronize()
    launches["int8"] = dict(cb.LAUNCHES)
    check_results(res, 8)
    n = launches["int8"]["decode_attention_int8_grouped"]
    log(f"  int8, Dh 128 (8 heads, 2 layers), 8 requests: frames "
        f"{[r.frames for r in res]}, decode_attention_int8_grouped "
        f"launches {n}")
    if n <= 0 or synth.last_decode_mode != "int8":
        raise RuntimeError("int8 at Dh 128 did not launch its kernel")
    launches.update(run_transposed_modes(model, info, "@dh128"))
    del synth, model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3b: prompt wav through the CLI
# ---------------------------------------------------------------------------

PROMPT_S = 3.0          # prompt seconds (225 frames at 75 Hz)
CLI_GEN = 64            # --max-gen-len of the CLI runs
ENCODE_LIMIT = 1e-4     # latents, card vs CPU, relative to the largest
CODE_SHARE = 0.98       # codes equal per quantizer, card vs CPU


def prompt_wav(path, seed, sr=16_000):
    """A seeded 16 kHz prompt of PROMPT_S seconds (tones and noise)."""
    import numpy as np

    from valle_tpu_torch import native

    rng = np.random.RandomState(seed)
    t = np.arange(int(PROMPT_S * sr)) / sr
    w = (0.3 * np.sin(2 * np.pi * (150 + 25 * seed) * t)
         + 0.1 * np.sin(2 * np.pi * 1300 * t) + 0.03 * rng.randn(t.size))
    native.write_wav(str(path), w.astype(np.float32), sr)


def weight_normed(codec_sd):
    """The port's codec state dict in the encodec package's weight-normed
    form: each conv weight w as weight_g = |w| (over every dim but 0) and
    weight_v = w."""
    out = {}
    for k, v in codec_sd.items():
        v = v.detach().cpu()
        if k.endswith(".weight") and (".conv.conv." in k
                                      or ".convtr.convtr." in k):
            dims = tuple(range(1, v.ndim))
            out[k[:-len("weight")] + "weight_g"] = v.norm(dim=dims,
                                                          keepdim=True)
            out[k[:-len("weight")] + "weight_v"] = v
        else:
            out[k] = v
    return out


def write_cli_files(model32, audio_tok, d):
    """The CLI's inputs in ``d``: the fp32 model as a reference-format .pt
    with its hyperparameters and symbol table, the codec in encodec's
    weight-normed form, 9 seeded 16 kHz prompt wavs and a two-line TSV."""
    import torch

    from valle_tpu_torch.utils.symbol_table import SymbolTable

    table = SymbolTable(eps=None)
    for i, s in enumerate(["<pad>", "<bos>", "<eos>"]
                          + sorted(set("abcdefghijklmnopqrstuvwxyz_"))):
        table.add(s, i)
    table.to_file(d / "tokens.k2symbols")
    torch.save({"model": {k: v.cpu() for k, v in
                          model32.state_dict().items()},
                "model_name": "VALL-E", "decoder_dim": FULL["d_model"],
                "nhead": FULL["nhead"],
                "num_decoder_layers": FULL["num_layers"],
                "prefix_mode": FULL["prefix_mode"],
                "num_quantizers": FULL["num_quantizers"],
                "text_tokens": str(d / "tokens.k2symbols")}, d / "m.pt")
    torch.save(weight_normed(audio_tok.codec.state_dict()), d / "codec.th")
    for i in range(9):
        prompt_wav(d / f"p{i}.wav", seed=i)
    (d / "demo.tsv").write_text(
        f"a prompt\t{d / 'p1.wav'}\t{TEXTS[0]}\t{d / 'tsv' / 'a.wav'}\n"
        f"another prompt\t{d / 'p2.wav'}\t{TEXTS[1]}\t"
        f"{d / 'tsv' / 'b.wav'}\n")


def check_encoder(audio_tok, d, info):
    """The 3 s prompt encoded on the card with TF32 switched on, as the
    caller may leave it, and on the CPU with the same codec: the latents
    the encode computes (caught by a hook on the encoder) within
    ENCODE_LIMIT of the largest entry, codes equal on >= CODE_SHARE of the
    frames of each quantizer, and the caller's TF32 settings restored. The
    same encode without the TF32 guard is read too: what TF32 would do to
    latents and codes (logged, not gated)."""
    import torch

    from valle_tpu_torch import native
    from valle_tpu_torch.codec.model import encodec_encode
    from valle_tpu_torch.codec.quantization import rvq_encode
    from valle_tpu_torch.codec.seanet import seanet_encoder_apply

    w, sr = native.read_wav(str(d / "p0.wav"))
    wav = torch.from_numpy(native.convert_audio(w, sr, 24_000))[None, :,
                                                                 None]
    card = audio_tok.codec
    cpu = copy.deepcopy(card).cpu()
    ref = encodec_encode(cpu, wav)
    with torch.no_grad():
        lat_ref = seanet_encoder_apply(cpu.encoder, wav)
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, mm.allow_tf32)
    seen = []
    hook = card.encoder.register_forward_hook(
        lambda mod, inp, out: seen.append(out.transpose(1, 2).cpu()))
    cudnn.allow_tf32 = mm.allow_tf32 = True
    try:
        codes = encodec_encode(card, wav.cuda()).cpu()
        restored = cudnn.allow_tf32 and mm.allow_tf32
        hook.remove()
        with torch.no_grad():
            lat_tf32 = seanet_encoder_apply(card.encoder, wav.cuda())
            codes_tf32 = rvq_encode(card.quantizer, lat_tf32, 8).cpu()
    finally:
        hook.remove()
        cudnn.allow_tf32, mm.allow_tf32 = prev
    top = lat_ref.abs().max()
    rel = ((seen[0] - lat_ref).abs().max() / top).item()
    rel_tf32 = ((lat_tf32.cpu() - lat_ref).abs().max() / top).item()
    share = (codes == ref).float().mean(dim=(0, 1)).tolist()
    share_tf32 = (codes_tf32 == ref).float().mean(dim=(0, 1)).tolist()
    log(f"  encoder on the card (TF32 on outside the encode) vs the CPU, "
        f"{PROMPT_S:g} s prompt {tuple(codes.shape)}: latents rel err "
        f"{rel:.3e} (limit {ENCODE_LIMIT:g}), codes equal per quantizer "
        f"{[round(x, 4) for x in share]} (gate {CODE_SHARE:g}), settings "
        f"restored {restored}; without the guard (TF32): latents rel err "
        f"{rel_tf32:.3e}, codes equal {[round(x, 4) for x in share_tf32]}")
    info["encoder_check"] = {"latent_rel_err": rel, "code_share": share,
                             "tf32_restored": restored,
                             "unguarded_tf32": {"latent_rel_err": rel_tf32,
                                                "code_share": share_tf32}}
    if codes.shape != (1, 225, 8):
        raise RuntimeError(f"encode gave codes {tuple(codes.shape)}")
    if len(seen) != 1 or not restored:
        raise RuntimeError("the encode did not run its encoder once or did "
                           "not restore the TF32 settings")
    if not rel <= ENCODE_LIMIT or min(share) < CODE_SHARE:
        raise RuntimeError("the encoder on the card disagrees with the CPU")


def check_wav(path, frames=None):
    import numpy as np

    from valle_tpu_torch import native

    w, sr = native.read_wav(str(path))
    n = w.shape[0]
    if sr != 24_000 or n <= 0 or n % 320 or not np.isfinite(w).all():
        raise RuntimeError(f"{path}: bad wav ({n} samples at {sr} Hz)")
    if frames is not None and n != frames * 320:
        raise RuntimeError(f"{path}: {n} samples, expected {frames} x 320")
    return n // 320


def run_cli(d, info):
    """bin.infer.main in-process, fp32, --decode-mode fused: plainly
    (counts set to 0 before it and read after: B1 and B2 must launch),
    with --continual true (225 prompt frames: 225 - 112 = 113 frames out)
    and on the two-line TSV; under PyTorch's default TF32 settings (cuDNN
    on, matmuls off), as a fresh CLI process has them."""
    import torch

    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32, mm.allow_tf32 = True, False
    try:
        _run_cli(d, info)
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev


def _run_cli(d, info):
    import torch

    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.ops import cuda_build as cb

    argv = ["--checkpoint", str(d / "m.pt"), "--encodec-weights",
            str(d / "codec.th"), "--text-extractor", "char",
            "--text-prompts", "a prompt", "--audio-prompts",
            str(d / "p0.wav"), "--top-k", "10", "--max-gen-len",
            str(CLI_GEN), "--decode-mode", "fused", "--device", "cuda"]
    res = {}
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    infer.main(argv + ["--text", TEXTS[0], "--output-dir", str(d / "plain")])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k: cb.LAUNCHES[k] for k in INFERENCE_KERNELS[:2]}
    infer.main(argv + ["--text", TEXTS[0], "--output-dir", str(d / "cont"),
                       "--continual", "true"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    infer.main(argv + ["--text", str(d / "demo.tsv"), "--output-dir",
                       str(d / "unused")])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    res["frames"] = {"plain": check_wav(d / "plain" / "0.wav"),
                     "continual": check_wav(d / "cont" / "0.wav", 113),
                     "tsv": [check_wav(d / "tsv" / n)
                             for n in ("a.wav", "b.wav")]}
    res["wall_s"] = {"plain": t1 - t0, "continual": t2 - t1, "tsv": t3 - t2}
    res["launches_plain"] = launches
    log(f"  CLI fp32 fused (load + encode + synthesize + write): plain "
        f"{t1 - t0:.3f} s, continual {t2 - t1:.3f} s, TSV (2 lines) "
        f"{t3 - t2:.3f} s; frames {res['frames']}; plain run launches "
        f"{launches}")
    info["cli"] = res
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} never launched in the CLI run")


def run_prompt_wav_batch(model, audio_tok, d, info):
    """A bf16 "fused" Synthesizer batch of 8 requests with 3 s prompt wavs
    (counts set to 0 before it and read after): B1, B2 and the B4 forward
    of the NAR passes must launch."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.serving import SynthesisRequest

    reqs = [SynthesisRequest(text=t, prompt_wav=str(d / f"p{i + 1}.wav"))
            for i, t in enumerate(TEXTS)]
    synth = build_synth(model, audio_tok, "fused")
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res = synth.synthesize(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: cb.LAUNCHES[k] for k in INFERENCE_KERNELS}
    check_results(res, 8)
    log(f"  prompt-wav batch, bf16 fused, 8 requests with {PROMPT_S:g} s "
        f"16 kHz prompts: {wall:.3f} s (encode + synthesize), frames "
        f"{[r.frames for r in res]}, launches {launches}")
    info["prompt_wav_batch"] = {"wall_s": wall, "launches": launches,
                                "frames": [r.frames for r in res]}
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} never launched in the prompt-wav batch")


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------


def time_ar(model, info):
    """AR decode frames/s at the bench shape in every mode, and at a long
    cache (735 frames, cache 1026: the JAX policy's int8 regime); one run
    each, to keep the script inside its time."""
    import torch

    res = {}
    for gen_len, modes, runs in (
            (150, ALL_DECODE_MODES, 1),
            (735, ("int8", "fused_int8", "fused", "exact", "fused_kv",
                   "fused_lanes", "mega"), 1)):
        res[f"gen{gen_len}"] = time_ar_modes(model, gen_len, modes, runs)
        torch.cuda.empty_cache()
    info["ar_decode"] = res


def time_ar_modes(model, GEN, modes, runs=2):
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode

    B, S, P = 32, 64, 225
    gen = torch.Generator("cuda").manual_seed(5)
    text = torch.randint(0, 100, (B, S), generator=gen, device="cuda")
    tl = torch.full((B,), S, device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    pl = torch.full((B,), P, device="cuda")
    res = {}
    for mode in modes:
        def run(frames=GEN):
            return valle_ar_decode(model, text, tl, pq, pl, generator=gen,
                                   top_k=10, max_gen_len=frames,
                                   compute_dtype=torch.bfloat16,
                                   force_full_length=True, decode_mode=mode)
        run(16)     # warm up the mode's code path; the best of runs
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        res[mode] = {"s": times, "frames_per_s": B * GEN / best,
                     "ms_per_step": best / GEN * 1e3}
        log(f"  AR decode {mode} (B {B}, {GEN} frames, cache "
            f"{S + P + GEN + 2}): {B * GEN / best:.1f} frames/s "
            f"({best / GEN * 1e3:.3f} ms/step, runs {times})")
    return res


def time_nar(model, info):
    import torch

    from valle_tpu_torch.modules.transformer import encoder_stack_apply
    from valle_tpu_torch.ops import masks as M

    gen = torch.Generator("cuda").manual_seed(6)
    T = 64 + 225 + 150
    res = {}
    for B in (8, 32):
        seq = torch.randn(B, T, model.cfg.nar_d_model, generator=gen,
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

    from valle_tpu_torch.codec.model import encodec_decode, encodec_encode

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
    res = {}
    for B in (1, 8):
        wav = (0.3 * torch.randn(B, int(PROMPT_S * 24_000), 1, generator=gen,
                                 device="cuda")).clamp(-1, 1)
        ms = cuda_ms(lambda: encodec_encode(audio_tok.codec, wav), iters=5,
                     warmup=1)
        res[f"B{B}_float32_ms"] = ms
        log(f"  codec encode B={B} {PROMPT_S:g} s float32: {ms:.3f} ms")
    info["codec_encode"] = res


def roofline(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the bf16 operations over the tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(times, bounds, library):
    """Decode-step kernels at B=32, bf16: B1/B2 by ``time_dense``, with
    the bound from the bytes each call must move; the NAR pass's flash
    forward by ``pair_ms``."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import masks as M
    from valle_tpu_torch.ops.flash_mha import (flash_mha_forward,
                                               reference_mha)

    gen = torch.Generator("cuda").manual_seed(8)
    dt = torch.bfloat16
    B, D, Fd = 32, 1024, 4096
    saved = dict(cb.LAUNCHES)
    layer = time_dense(times, library, B=B, D=D, Fd=Fd)
    act = 2 * B * D * 2                      # bf16 rows in and out
    # weights of 2 bytes (bf16) or 1 byte plus a 4-byte scale a channel;
    # LayerNorm and bias parameters in bf16
    for sfx, wb, scales in (("", 2, 0), ("_w8", 1, 4)):
        bounds[f"fused_ln_qkv{sfx}"] = roofline(
            3 * D * D * wb + 3 * D * scales + B * D * 2 + B * 3 * D * 2
            + (2 * D + 3 * D) * 2, 2 * B * D * 3 * D)
        bounds[f"fused_tail{sfx}"] = roofline(
            9 * D * D * wb + (2 * D + Fd) * scales + act + B * D * 2
            + (7 * D) * 2, 18 * B * D * D)
    # the NAR pass's forward (inference shape B=8, S=T=439, no dropout)
    Bn, H, S, Dh = 8, 16, 64 + 225 + 150, 64
    q, k, v = (torch.randn(Bn, H, S, Dh, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    kv = torch.arange(S, device="cuda")[None].expand(Bn, S) < S - 10
    qc, kc = M.flash_codes_key_valid(kv)
    times["flash_mha_fwd_nar_pass"] = pair_ms(
        lambda: flash_mha_forward(q, k, v, qc, kc),
        lambda: reference_mha(q, k, v, qc, kc))
    log(f"  flash_mha_fwd_nar_pass: key tiles skipped "
        f"{skipped_tile_share(qc, kc):.3f}")
    for name, val in times.items():
        if name == "dense_cold":
            continue
        ms, plain, eager, plain_eager = val
        b = (f"; bound {bounds[name][0]:.5f} ms ({bounds[name][1]})"
             if name in bounds else "")
        lib = (f"; library {library[name]:.5f} ms" if name in library
               else "")
        log(f"  {name}: device kernel {ms:.5f} ms, plain {plain:.4f} ms; "
            f"eager call kernel {eager:.4f} ms, plain {plain_eager:.4f} ms"
            f"{lib}{b} (bf16; dense B=32, flash B=8 H=16 S=439)")
    log("  int8 weights: no PyTorch call computes a product over int8 "
        "weights with per-channel scales, so no library time")
    times["dense_pdl"] = pdl_overlap(*layer)
    cb.LAUNCHES.update(saved)   # timing launches do not count


def time_dense(times, library, B, D, Fd, layers=12):
    """B1 fused_ln_qkv and B2 fused_tail at the decode step (bf16
    activations, LayerNorm and bias parameters), with bf16 and with int8
    weights; their plain versions; and for bf16 weights the library chain
    (bf16 F.layer_norm + F.linear; no PyTorch call computes a product over
    int8 weights with per-channel scales). Device ms a call by replay of a
    CUDA graph of ``layers`` calls: with one layer's weights again and
    again ("hot": they stay in L2; the kernels line's figures), and with
    ``layers`` layers' weights in turn ("cold": 288 MB of bf16 at d 1024,
    past the 50 MB L2, as an AR step reads them). Kernel and library are
    timed in turns (library, kernel, kernel, library), the lesser of each
    pair kept; eager ms a call shows the host's cost. Fills times[name] =
    (kernel, plain, eager kernel, eager plain), library[name] and
    times["dense_cold"] (us a call, hot and cold); returns (h, a, layer
    0's tensors). Runs against whichever valle_tpu_torch is imported."""
    import torch
    import torch.nn.functional as F

    from valle_tpu_torch.ops import fused_dense as fd

    dt = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(13)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    h, a = r(B, D).to(dt), r(B, D).to(dt)
    ws = []
    for _ in range(layers):
        w = {n: r(*shape, scale=shape[1] ** -0.5).to(dt)
             for n, shape in (("in_w", (3 * D, D)), ("out_w", (D, D)),
                              ("w1", (Fd, D)), ("w2", (D, Fd)))}
        w.update({n: (c + 0.1 * r(size)).to(dt) for n, c, size in (
            ("ln_w", 1.0, D), ("ln_b", 0.0, D), ("in_b", 0.0, 3 * D),
            ("out_b", 0.0, D), ("b1", 0.0, Fd), ("b2", 0.0, D))})
        for n in ("in_w", "out_w", "w1", "w2"):
            w[n + "8"], w[n + "_s"] = fd.quantize_weights_per_channel(w[n])
        ws.append(w)

    def qkv(w, q, f):
        return f(h, w["ln_w"], w["ln_b"], w["in_w" + q], w["in_b"],
                 w_scale=w["in_w_s"] if q else None)

    def tail(w, q, f):
        sc = (w["out_w_s"], w["w1_s"], w["w2_s"]) if q else None
        return f(a, h, w["out_w" + q], w["out_b"], w["ln_w"], w["ln_b"],
                 w["w1" + q], w["b1"], w["w2" + q], w["b2"], w_scales=sc)

    def qkv_lib(w):
        return F.linear(F.layer_norm(h, (D,), w["ln_w"], w["ln_b"]),
                        w["in_w"], w["in_b"])

    def tail_lib(w):
        h1 = h + F.linear(a, w["out_w"], w["out_b"])
        x = F.layer_norm(h1, (D,), w["ln_w"], w["ln_b"])
        return h1 + F.linear(F.relu(F.linear(x, w["w1"], w["b1"])),
                             w["w2"], w["b2"])

    def per_call_ms(fn, seq):
        def run():
            for w in seq:
                fn(w)
        return graph_ms(run, iters=30) / len(seq)

    hot, cold = ws[:1] * layers, ws
    us = {}
    for name, call, lib, plain in (
            ("fused_ln_qkv", qkv, qkv_lib, fd.fused_ln_qkv_plain),
            ("fused_tail", tail, tail_lib, fd.fused_tail_plain)):
        fused = getattr(fd, name)
        for q in ("", "8"):
            key = name + ("_w8" if q else "")
            kern = (lambda w, call=call, q=q, f=fused: call(w, q, f))
            ref = (lambda w, call=call, q=q, f=plain: call(w, q, f))
            l1 = None if q else per_call_ms(lib, hot)
            k1, k2 = per_call_ms(kern, hot), per_call_ms(kern, hot)
            l2 = None if q else per_call_ms(lib, hot)
            times[key] = (min(k1, k2), per_call_ms(ref, hot),
                          cuda_ms(lambda: kern(ws[0])),
                          cuda_ms(lambda: ref(ws[0])))
            us[key] = {"hot_us": times[key][0] * 1e3,
                       "cold_us": per_call_ms(kern, cold) * 1e3}
            if not q:
                library[key] = min(l1, l2)
                us["library_" + key] = {
                    "hot_us": library[key] * 1e3,
                    "cold_us": per_call_ms(lib, cold) * 1e3}
    for key, v in us.items():
        log(f"  {key} (B {B}, bf16 parameters): one layer's weights "
            f"{v['hot_us']:.2f} us, {layers} layers' in turn "
            f"{v['cold_us']:.2f} us a call")
    times["dense_cold"] = us
    return h, a, ws[0]


def pdl_overlap(h, a, w):
    """Kernels per call of the bf16 dense wrappers (fails unless
    fused_ln_qkv is one and fused_tail three), and whether a dense kernel
    (launched with programmatic dependent launch) starts before its
    predecessor ends: from torch.profiler traces of back-to-back
    fused_tail calls, eager and as the replay of a CUDA graph of them (as
    graph_ms times them). w: one layer's bf16 tensors (time_dense)."""
    import torch

    from valle_tpu_torch.ops import fused_dense as fd

    def tail():
        return fd.fused_tail(a, h, w["out_w"], w["out_b"], w["ln_w"],
                             w["ln_b"], w["w1"], w["b1"], w["w2"], w["b2"])

    def qkv():
        return fd.fused_ln_qkv(h, w["ln_w"], w["ln_b"], w["in_w"],
                               w["in_b"])

    reps, res = 20, {}
    for name, fn, want in (("fused_ln_qkv", qkv, 1), ("fused_tail", tail, 3)):
        n = len(trace_kernels(fn, reps))
        res[f"{name}_kernels_per_call"] = n / reps
        log(f"  {name} (bf16, B 32): {n / reps:g} kernels a call")
        if n != want * reps:
            raise RuntimeError(f"{name}: {n / reps:g} kernels a call, "
                               f"expected {want}")
    g = torch.cuda.CUDAGraph()
    tail()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        tail()
    for label, fn in (("eager", tail), ("graph replay", g.replay)):
        ks = trace_kernels(fn, reps)
        # each kernel's start minus the end of the kernel before
        # (negative: they overlap)
        gaps = [ks[i]["ts"] - (ks[i - 1]["ts"] + ks[i - 1]["dur"])
                for i in range(1, len(ks))]
        over = sum(1 for x in gaps if x < 0)
        res[f"{label}_gaps_us"] = gaps
        log(f"  fused_tail {label}: {over} of {len(gaps)} kernel boundaries "
            f"overlap; gap min {min(gaps):.2f} us, median "
            f"{sorted(gaps)[len(gaps) // 2]:.2f} us")
    return res


def time_decode_kernels(times, bounds, library, info):
    """The decode kernels at the bench step (B 32, H 16, Dh 64, cache 512,
    365 valid keys a row), bf16: kernel and plain device time by graph
    replay, the bound from the valid keys' bytes, and the library
    yardstick (timed here only): scaled_dot_product_attention with the
    boolean mask over the bf16 cache; for fused_attn_tail that plus the
    bf16 F.linear / F.layer_norm tail. fused_attn_tail also at Dh 128
    (8 heads), beside the fused_lanes sequence (decode_attention_lanes +
    fused_tail), with its launches apart from a profiler trace."""
    import torch
    import torch.nn.functional as F

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops.decode_attention_kv import key_valid

    gen = torch.Generator("cuda").manual_seed(12)
    dt = torch.bfloat16
    B, H, Dh, T, S = (DEC[k] for k in ("B", "H", "Dh", "T", "S"))
    q, k, v, x_lens, wp = decode_inputs(dt, gen, spread=False)
    caches = decode_caches(k, v)
    saved = dict(cb.LAUNCHES)
    for name, (kern, plain) in decode_calls(q, caches, x_lens, wp).items():
        times[name] = pair_ms(kern, plain)
    cb.LAUNCHES.update(saved)   # timing launches do not count

    valid = key_valid(x_lens, wp, S, T)
    mask = valid[:, None, None, :]
    sdpa_ms = min(graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)) for _ in range(2))
    for name in DECODE_KERNELS[:3]:
        library[name] = sdpa_ms
    n_valid = int(valid.sum())                   # valid (row, key) pairs
    small = B * H * Dh * 2 * 2 + 2 * B * 4       # q in, out, x_lens, wp
    attn_ops = 4 * n_valid * H * Dh
    bounds["decode_attention_kv"] = roofline(
        n_valid * H * 2 * Dh * 2 + small, attn_ops)
    bounds["decode_attention_lanes"] = bounds["decode_attention_kv"]
    bounds["decode_attention_int8_grouped"] = roofline(
        n_valid * H * (2 * Dh + 2 * 4) + small, attn_ops)
    time_int8_dh128(times, bounds, library, gen, x_lens, wp)
    for H_, D_, sfx in ((H, Dh, ""), (DH128["H"], DH128["Dh"], "@dh128")):
        time_attn_tail(H_, D_, sfx, times, bounds, library, info, gen)
    for name in DECODE_KERNELS + ("fused_attn_tail@dh128",
                                  "decode_attention_int8_grouped@dh128"):
        ms, plain, eager, plain_eager = times[name]
        b = bounds[name]
        log(f"  {name}: device kernel {ms:.4f} ms, plain {plain:.4f} ms; "
            f"eager call kernel {eager:.4f} ms, plain {plain_eager:.4f} ms; "
            f"library {library[name]:.4f} ms; bound {b[0]:.4f} ms ({b[1]}) "
            f"(bf16, B {B}, cache {T}, {n_valid / B:.0f} valid keys a row"
            f"{', H 8, Dh 128' if name.endswith('@dh128') else ', H 16'})")
    times["decode_scaling"] = decode_scaling(gen)


def time_int8_dh128(times, bounds, library, gen, x_lens, wp):
    """decode_attention_int8_grouped at the bench step with 8 heads of
    128 (d_model 1024), bf16: kernel and plain by graph replay, the bound
    from the valid keys' int8 rows and scales, SDPA over the bf16 cache."""
    import torch
    import torch.nn.functional as F

    from valle_tpu_torch.modules.transformer import quantize_kv
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import decode_attention_int8_grouped as d8
    from valle_tpu_torch.ops.decode_attention_kv import key_valid

    B, T, S = DEC["B"], DEC["T"], DEC["S"]
    H, Dh = DH128["H"], DH128["Dh"]
    name = "decode_attention_int8_grouped@dh128"
    q, k, v, _, _ = decode_inputs(torch.bfloat16, gen, spread=False, H=H,
                                  Dh=Dh)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    i8 = (d8.combine_kv_int8(kq, vq), d8.stack_scales(ks, vs))
    saved = dict(cb.LAUNCHES)
    times[name] = pair_ms(
        lambda: d8.decode_attention_int8_grouped(q, *i8, x_lens, wp, S=S),
        lambda: d8.decode_attention_int8_grouped_plain(q, *i8, x_lens, wp,
                                                       S=S))
    cb.LAUNCHES.update(saved)   # timing launches do not count
    valid = key_valid(x_lens, wp, S, T)
    mask = valid[:, None, None, :]
    library[name] = min(graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)) for _ in range(2))
    n_valid = int(valid.sum())
    bounds[name] = roofline(n_valid * H * (2 * Dh + 2 * 4)
                            + B * H * Dh * 2 * 2 + 2 * B * 4,
                            4 * n_valid * H * Dh)


def time_attn_tail(H, Dh, sfx, times, bounds, library, info, gen):
    """fused_attn_tail at the bench step with H heads of Dh (d_model H *
    Dh, FFN 4096), bf16: kernel and plain by graph replay, the library
    chain (SDPA + the F.linear / F.layer_norm tail), the fused_lanes
    sequence in turns with it, and its kernels apart (trace of 20 calls:
    ms a call by kernel name, in launch order)."""
    import torch
    import torch.nn.functional as F

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import decode_attention_lanes as dln
    from valle_tpu_torch.ops import fused_attn_tail as fat
    from valle_tpu_torch.ops import fused_dense as fd
    from valle_tpu_torch.ops.decode_attention_kv import key_valid

    dt = torch.bfloat16
    B, T, S, Fd = DEC["B"], DEC["T"], DEC["S"], 4096
    D = H * Dh
    name = "fused_attn_tail" + sfx
    q, k, v, x_lens, wp = decode_inputs(dt, gen, spread=False, H=H, Dh=Dh)
    lanes = dln.combine_kv_lanes(k, v)
    p = dense_inputs(B, D, Fd, dt, gen)
    args = attn_tail_args(q, lanes, x_lens, wp, p, dt)
    saved = dict(cb.LAUNCHES)
    times[name] = pair_ms(lambda: fat.fused_attn_tail(*args, S=S),
                          lambda: fat.fused_attn_tail_plain(*args, S=S))

    def lanes_then_tail():
        a = dln.decode_attention_lanes(q, lanes, x_lens, wp, S=S, nhead=H)
        return fd.fused_tail(a.reshape(B, D), *args[1:2], *args[5:])

    seq = pair_ms(lanes_then_tail, lambda: fat.fused_attn_tail(*args, S=S))
    split = kernel_split(lambda: fat.fused_attn_tail(*args, S=S))
    cb.LAUNCHES.update(saved)   # timing launches do not count
    valid = key_valid(x_lens, wp, S, T)
    mask = valid[:, None, None, :]
    w = dense_weights(p, dt, False)
    _, h_res, _, _, _, _, out_b, ln_w, ln_b, _, b1, _, b2 = args

    def tail_lib():
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        h1 = h_res + F.linear(a.reshape(B, D), w["out_w"], out_b)
        x = F.layer_norm(h1, (D,), ln_w, ln_b)
        return h1 + F.linear(F.relu(F.linear(x, w["w1"], b1)), w["w2"], b2)

    library[name] = min(graph_ms(tail_lib) for _ in range(2))
    n_valid = int(valid.sum())
    weights = (D * D + 2 * D * Fd) * 2 + (5 * D + Fd) * 2
    bounds[name] = roofline(
        n_valid * H * 2 * Dh * 2 + B * D * 2 * 2 + 2 * B * 4 + weights
        + 2 * B * D * 2, 4 * n_valid * H * Dh + 2 * B * D * D
        + 4 * B * D * Fd)
    info["fused_lanes_sequence" + sfx] = {
        "sequence_ms": seq[0], "fused_attn_tail_ms": seq[1],
        "what": "decode_attention_lanes + fused_tail vs fused_attn_tail, "
                "device time by graph replay in turns"}
    info["fused_attn_tail_kernels" + sfx] = split
    log(f"  {name} {seq[1]:.4f} ms vs the fused_lanes sequence "
        f"(decode_attention_lanes + fused_tail) {seq[0]:.4f} ms (device, "
        f"same shape, H {H}, Dh {Dh})")
    log(f"  {name} launches apart (ms a call): " + "; ".join(
        f"{kn} {ms:.4f}" for kn, ms in split.items()))


def decode_scaling(gen):
    """Whether a small batch or a long cache leaves the decode kernels far
    from their bound: their device time against it at B 8 and 32, caches
    512 (365 valid keys a row) and 1024 (the 735-frame run's mean step,
    657 valid keys), bf16; and B8 over the transposed cache at B 6 (the
    per_sample run's batch) and 32."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import decode_attention as dt8
    from valle_tpu_torch.ops.decode_attention_kv import key_valid

    H, Dh, S = DEC["H"], DEC["Dh"], DEC["S"]
    res = {}
    saved = dict(cb.LAUNCHES)
    for B, T, wp_val in ((8, 512, S + 300), (32, 512, S + 300),
                         (8, 1024, S + 225 + 367), (32, 1024, S + 225 + 367),
                         (6, 512, S + 300), (6, 1024, S + 225 + 367)):
        q, k, v = (torch.randn(B, H, n, Dh, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for n in (1, T, T))
        x_lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        wp = torch.full((B,), wp_val, dtype=torch.int32, device="cuda")
        n_valid = int(key_valid(x_lens, wp, S, T).sum())
        bound = roofline(n_valid * H * 2 * Dh * 2 + B * H * Dh * 4,
                         4 * n_valid * H * Dh)[0]
        if B != 6:
            caches = decode_caches(k, v)
            for name, (kern, _) in decode_calls(q, caches, x_lens,
                                                wp).items():
                row = 2 * Dh * (1 if "int8" in name else 2) + (
                    8 if "int8" in name else 0)
                b_ = roofline(n_valid * H * row + B * H * Dh * 4,
                              4 * n_valid * H * Dh)[0]
                ms = min(graph_ms(kern) for _ in range(2))
                res[f"{name} B{B} T{T}"] = {"ms": ms, "bound_ms": b_,
                                             "share": b_ / ms}
                log(f"  {name} B {B}, cache {T}, {n_valid // B} valid keys "
                    f"a row: {ms:.4f} ms, bound {b_:.4f} ms "
                    f"({b_ / ms:.0%} of the bound)")
            del caches
        if B == 8:
            continue
        kt, vt = (x.transpose(-1, -2).contiguous() for x in (k, v))
        ms = min(graph_ms(lambda: dt8.decode_attention(
            q, kt, vt, x_lens, wp, S=S)) for _ in range(2))
        res[f"decode_attention B{B} T{T}"] = {"ms": ms, "bound_ms": bound,
                                               "share": bound / ms}
        log(f"  decode_attention B {B}, cache {T}, {n_valid // B} valid "
            f"keys a row: {ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound / ms:.0%} of the bound)")
        del q, k, v, kt, vt
    cb.LAUNCHES.update(saved)
    return res


def time_attention_kernels(times, bounds, library, info):
    """B6/B7 at the NAR-pass shape (B 8, H 16, S = T = 439; 84 of B6's 96
    launches a batch) and the AR prefill shape (S = T = 289), at Dh 64 and
    at Dh 128 (8 heads; entries "<kernel>@dh128"), B8/B9 at the bench
    decode step (B 32, 365 valid keys a row), bf16: kernel and
    plain device time by graph replay; the library yardstick (timed here
    only): scaled_dot_product_attention with the float bias (B6), the
    boolean mask of the lengths (B7) or of the valid keys over the natural
    (B, H, T, Dh) cache (B8/B9); the bound from the bytes each call must
    move and the operations over its visible (query, key) pairs; the share
    of key tiles B7 skips."""
    import torch
    import torch.nn.functional as F

    from valle_tpu_torch.ops import attention as pa
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import decode_attention as dt8
    from valle_tpu_torch.ops import decode_attention_grouped as dt9
    from valle_tpu_torch.ops.decode_attention_kv import key_valid

    gen = torch.Generator("cuda").manual_seed(16)
    dt = torch.bfloat16
    B, St = PREFILL["B"], PREFILL["S_text"]
    saved = dict(cb.LAUNCHES)
    shapes, names = {}, []
    for H, Dh, dsfx in ((PREFILL["H"], PREFILL["Dh"], ""),
                        (DH128["H"], DH128["Dh"], "@dh128")):
        for shape in ("nar", "prefill"):
            sfx = ("" if shape == "nar" else "_prefill") + dsfx
            T, bias = attn_bias(shape, gen)
            q, k, v = attn_views(B, T, H, Dh, dt, gen)
            clamped = pa._clamp(bias)
            times["flash_attention" + sfx] = pair_ms(
                lambda: pa.flash_attention(q, k, v, bias),
                lambda: pa.naive_attention(q, k, v, clamped))
            mask16 = clamped.to(dt)
            library["flash_attention" + sfx] = min(graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask16))
                for _ in range(2))
            vis = (bias > float("-inf")).expand(B, 1, T, T)
            bounds["flash_attention" + sfx] = roofline(
                attn_bytes(vis, H, Dh) + bias.numel() * 4,
                4 * int(vis.sum()) * H * Dh)
            causal = shape == "prefill"
            T, x_lens, y_lens, lb = lens_case(causal, gen)
            q, k, v = attn_views(B, T, H, Dh, dt, gen)
            times["flash_attention_lens" + sfx] = pair_ms(
                lambda: pa.flash_attention_lens(q, k, v, x_lens, y_lens, St,
                                                causal),
                lambda: pa.naive_attention(q, k, v, lb))
            vis = (lb > pa.NEG_INF).expand(B, 1, T, T)
            library["flash_attention_lens" + sfx] = min(graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=vis))
                for _ in range(2))
            bounds["flash_attention_lens" + sfx] = roofline(
                attn_bytes(vis, H, Dh) + 2 * B * 4,
                4 * int(vis.sum()) * H * Dh)
            info["flash_attention_lens" + sfx + "_skipped_tiles"] = (
                lens_skipped_share(x_lens, y_lens, St, causal, T))
            shapes[shape] = T
            names += ["flash_attention" + sfx, "flash_attention_lens" + sfx]
    cb.LAUNCHES.update(saved)   # timing launches do not count
    S = DEC["S"]
    for H, Dh, sfx in ((DEC["H"], DEC["Dh"], ""),
                       (DH128["H"], DH128["Dh"], "@dh128")):
        q, k, v, x_lens, wp = decode_inputs(dt, gen, spread=False, H=H,
                                            Dh=Dh)
        kt, vt = (x.transpose(-1, -2).contiguous() for x in (k, v))
        times["decode_attention" + sfx] = pair_ms(
            lambda: dt8.decode_attention(q, kt, vt, x_lens, wp, S=S),
            lambda: dt8.decode_attention_plain(q, kt, vt, x_lens, wp, S=S))
        times["decode_attention_grouped" + sfx] = pair_ms(
            lambda: dt9.decode_attention_grouped(q, kt, vt, x_lens, wp, S=S),
            lambda: dt9.decode_attention_grouped_plain(q, kt, vt, x_lens,
                                                       wp, S=S))
        cb.LAUNCHES.update(saved)
        valid = key_valid(x_lens, wp, S, DEC["T"])
        mask = valid[:, None, None, :]
        sdpa_ms = min(graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)) for _ in range(2))
        n_valid = int(valid.sum())
        for name in ("decode_attention", "decode_attention_grouped"):
            library[name + sfx] = sdpa_ms
            bounds[name + sfx] = roofline(
                n_valid * H * 2 * Dh * 2 + DEC["B"] * H * Dh * 2 * 2
                + 2 * DEC["B"] * 4, 4 * n_valid * H * Dh)
            names.append(name + sfx)
    for name in names:
        ms, plain, eager, plain_eager = times[name]
        b = bounds[name]
        H, Dh = ((DH128["H"], DH128["Dh"]) if name.endswith("@dh128")
                 else (PREFILL["H"], PREFILL["Dh"]))
        if name.startswith("decode"):
            where = (f"bench decode step B 32, H {H}, Dh {Dh}, cache 512, "
                     f"{n_valid / DEC['B']:.0f} valid keys a row")
        else:
            T = shapes["prefill" if "prefill" in name else "nar"]
            where = f"B {B}, H {H}, Dh {Dh}, S = T = {T}"
            if "lens" in name:
                where += (", key tiles skipped "
                          f"{info[name + '_skipped_tiles']:.3f}")
        log(f"  {name}: device kernel {ms:.4f} ms, plain {plain:.4f} ms; "
            f"eager call kernel {eager:.4f} ms, plain {plain_eager:.4f} ms; "
            f"library {library[name]:.4f} ms; bound {b[0]:.4f} ms ({b[1]}) "
            f"(bf16, {where})")
    info["attention_kernel_shapes"] = shapes


def attn_bytes(vis, H, Dh):
    """bf16 bytes of q, k, v and the output that an attention over the
    (B, 1, S, T) visibility ``vis`` must move: every query row and output
    row; the k and v rows of the keys some row of the sample sees, or of
    all T keys where a row sees none (it averages over them)."""
    B, _, S, T = vis.shape
    blind = (~vis.any(dim=-1)).any(dim=-1, keepdim=True)     # (B, 1, 1)
    keys = int((vis.any(dim=-2) | blind).sum())
    return (2 * B * S + 2 * keys) * H * Dh * 2


def pair_ms(kernel, plain):
    """(device ms kernel, device ms plain, eager ms kernel, eager ms
    plain), measured in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (graph_ms(plain), graph_ms(kernel), graph_ms(kernel),
                      graph_ms(plain))
    return (min(k1, k2), min(p1, p2), cuda_ms(kernel), cuda_ms(plain))


def profile_busy(run, trace_name, warm=True):
    """Device busy share of run() from a torch.profiler trace: the union
    of kernel intervals over the window from the first kernel to the
    last; ``warm`` runs it once untraced first. Returns a dict, or None
    when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    path = Path("chiprun_out") / trace_name
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()   # large; the breakdown below is what is kept
    events = [e for e in trace if e.get("cat") == "kernel" and "dur" in e]
    if not events:
        return None
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    by_name = {}
    for e in events:
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
    window = (spans[-1][1] - spans[0][0]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    by_class = {}
    for e in events:
        cls = next((c for c, keys in KERNEL_CLASSES if any(
            k in e["name"] for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1e3
    host = {}
    for e in trace:
        if e.get("cat") == "cpu_op" and "dur" in e:
            host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"wall_ms": wall * 1e3, "kernel_window_ms": window,
            "busy_ms": busy / 1e3, "busy_share": busy / 1e3 / window,
            "kernels": len(spans),
            "top_kernels_ms": {k: v / 1e3 for k, v in top},
            "kernel_class_ms": by_class,
            "host_ops_ms": dict(sorted(host.items(),
                                       key=lambda kv: -kv[1])[:6])}


def log_busy(label, prof):
    if prof is None:
        log(f"  {label}: device busy share not measured (no kernel events "
            "in the trace)")
        return
    log(f"  {label}: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms of {prof['kernel_window_ms']:.1f} ms "
        f"({100 * prof['busy_share']:.1f}%), {prof['kernels']} kernels")
    for k, v in prof["top_kernels_ms"].items():
        log(f"    {v:8.2f} ms  {k}")
    log("    device ms by kernel class: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(prof["kernel_class_ms"].items(),
                                           key=lambda kv: -kv[1])))
    log("    host ms by op (inclusive): " + ", ".join(
        f"{k} {v:.2f}" for k, v in prof["host_ops_ms"].items()))


def device_busy(model, info):
    """Device busy share of fused and int8 AR decode at the bench
    shape."""
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode

    B, S, P = 32, 64, 225
    gen = torch.Generator("cuda").manual_seed(9)
    text = torch.randint(0, 100, (B, S), generator=gen, device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    n = torch.full((B,), S, device="cuda")
    pl = torch.full((B,), P, device="cuda")

    for mode in ("fused", "int8"):
        def run():
            valle_ar_decode(model, text, n, pq, pl, generator=gen, top_k=10,
                            max_gen_len=30, compute_dtype=torch.bfloat16,
                            force_full_length=True, decode_mode=mode)
            torch.cuda.synchronize()

        prof = profile_busy(run, f"trace_ar_{mode}.json")
        log_busy(f"AR {mode} 30 steps (B=32)", prof)
        if prof is not None:
            info[f"ar_{mode}_profile"] = prof


def ar_step_kernels(model, modes=("fused", "mega")):
    """Kernels a step of AR decode at the bench shape (B 32, text 64,
    prompt 225) in each mode: the kernels of a 40-frame run less those of
    a 30-frame run (the prefill cancels), over 10, from torch.profiler
    traces (``trace_kernels``)."""
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode

    B, S, P = 32, 64, 225
    gen = torch.Generator("cuda").manual_seed(9)
    text = torch.randint(0, 100, (B, S), generator=gen, device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    n = torch.full((B,), S, device="cuda")
    pl = torch.full((B,), P, device="cuda")
    out = {}
    for mode in modes:
        counts = []
        for frames in (30, 40):
            def run():
                valle_ar_decode(model, text, n, pq, pl, generator=gen,
                                top_k=10, max_gen_len=frames,
                                compute_dtype=torch.bfloat16,
                                force_full_length=True, decode_mode=mode)

            counts.append(len(trace_kernels(run, iters=1)))
        out[mode] = (counts[1] - counts[0]) / 10
        log(f"  AR {mode} (B 32): {out[mode]:g} kernels a step "
            f"({counts[0]} kernels in 30 frames, {counts[1]} in 40)")
    return out


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

AR_RECIPE = dict(B=16, S=96, T=375)     # benchmarks/bench_train_stage.py
NAR_RECIPE = dict(B=8, S=96, T=375)
TRAIN_STEPS = 5
SEED = 0x5EED


def attn_case(B, S, T, dt, gen, H=16, Dh=64):
    """q, k, v, g (B, H, S+T, Dh) and the AR composite codes of random
    text/audio lengths (every row sees a key)."""
    import torch

    from valle_tpu_torch.ops import masks as M

    n = S + T
    q, k, v, g = (torch.randn(B, H, n, Dh, generator=gen,
                              device="cuda").to(dt) for _ in range(4))
    x_lens = torch.randint(S // 2, S + 1, (B,), generator=gen, device="cuda")
    y_lens = torch.randint(T // 2, T + 1, (B,), generator=gen, device="cuda")
    x_lens[0], y_lens[0] = S, T
    qc, kc = M.flash_codes_ar_xy(x_lens, y_lens, S, T)
    return q, k, v, g, qc, kc


def skipped_tile_share(qc, kc, tile=64):
    """Share of (query tile, key tile) pairs of 64 x 64 that the flash
    kernels skip: no query of the tile can see a key of the other
    (largest qcode < smallest kcode), computed from the codes."""
    import torch

    B, S = qc.shape
    T = kc.shape[1]
    big = torch.iinfo(torch.int32).max
    nq, nk = -(-S // tile), -(-T // tile)
    qpad = torch.full((B, nq * tile), -big - 1, dtype=torch.int64,
                      device=qc.device)
    kpad = torch.full((B, nk * tile), big, dtype=torch.int64,
                      device=kc.device)
    qpad[:, :S], kpad[:, :T] = qc, kc
    qmax = qpad.view(B, nq, tile).amax(-1)
    kmin = kpad.view(B, nk, tile).amin(-1)
    return (qmax[:, :, None] < kmin[:, None, :]).float().mean().item()


def check_train_kernels(errs, H=16, Dh=64, key="",
                        kinds=("ar", "nar", "unseen row")):
    """Flash forward + backward against the plain versions at the AR
    recipe's attention shape, at the NAR recipe's (B 8, padding codes),
    and with one query that sees no key (its cotangent zero, the
    backward's contract); dropout masks bit for bit. H heads of Dh, the
    cases named in ``kinds``; the errors go to errs[kernel + key]."""
    import torch

    from valle_tpu_torch.ops import masks as M

    gen = torch.Generator("cuda").manual_seed(21)
    for dt in (torch.float32, torch.bfloat16):
        limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
        cases = {}
        for name, shape in (("ar", AR_RECIPE), ("nar", NAR_RECIPE)):
            B, S, T = shape["B"], shape["S"], shape["T"]
            q, k, v, g, qc, kc = attn_case(B, S, T, dt, gen, H=H, Dh=Dh)
            if name == "nar":
                x_lens = torch.randint(S // 2, S + 1, (B,), generator=gen,
                                       device="cuda")
                y_lens = torch.randint(T // 2, T + 1, (B,), generator=gen,
                                       device="cuda")
                qc, kc = M.flash_codes_padding(x_lens, y_lens, S, T)
            cases[name] = (q, k, v, g, qc, kc)
        # the AR case with query 100 of batch row 1 seeing no key
        q, k, v, g, qc, kc = cases["ar"]
        qc, g = qc.clone(), g.clone()
        qc[1, 100] = -1
        g[1, :, 100] = 0
        cases["unseen row"] = (q, k, v, g, qc, kc)
        cases = {n: c + ({},) for n, c in cases.items() if n in kinds}
        check_flash_cases(cases, dt, limit, errs, key, Dh)
        del cases
    torch.cuda.synchronize()


def check_flash_cases(cases, dt, limit, errs, key, Dh):
    """Each case (q, k, v, g, qcode, kcode, segment keywords) through the
    flash forward and backward against the plain versions, dropout 0 and
    0.1; two backward launches bit-equal; the kernels' Philox against the
    plain bytes for the "ar" case."""
    import torch

    from valle_tpu_torch.ops.flash_mha import (flash_mha_backward,
                                               flash_mha_forward,
                                               reference_mha,
                                               reference_mha_grads)
    from valle_tpu_torch.ops.philox import dropout_bytes

    for cname, (q, k, v, g, qc, kc, seg) in cases.items():
        seen = torch.ones(q.shape[:3], dtype=torch.bool, device="cuda")
        if cname == "unseen row":
            seen[1, :, 100] = False
        for rate in (0.0, 0.1):
            kw = dict(seg, dropout_rate=rate, seed=SEED if rate else None)
            tag = f"{cname} {str(dt)[6:]} Dh {Dh} dropout {rate}"
            out, lse = flash_mha_forward(q, k, v, qc, kc, **kw)
            grads = flash_mha_backward(q, k, v, qc, kc, out, lse, g,
                                       **kw)
            ref, ref_lse = reference_mha(q, k, v, qc, kc,
                                         return_lse=True, **kw)
            compare(f"flash_mha_fwd out {tag}", out, ref, limit,
                    errs["flash_mha_fwd" + key])
            compare(f"flash_mha_fwd lse {tag}", lse[seen],
                    ref_lse[seen], FP32_LIMIT, [])
            if not bool((lse[~seen] <= -1e29).all()):
                raise RuntimeError(f"{tag}: the unseen row's lse is "
                                   "not -1e30")
            del ref, ref_lse
            ref_grads = reference_mha_grads(q, k, v, qc, kc, g, **kw)
            for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
                compare(f"flash_mha_bwd {name} {tag}", a, b, limit,
                        errs["flash_mha_bwd" + key])
            del ref_grads
            again = flash_mha_backward(q, k, v, qc, kc, out, lse, g,
                                       **kw)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise RuntimeError(f"{tag}: two backward launches "
                                   "differ")
            if rate and cname == "ar":
                bits = dropout_bytes(SEED, *q.shape[:3], k.shape[2],
                                     device="cuda")
                out_b, lse_b = flash_mha_forward(q, k, v, qc, kc,
                                                 dropout_rate=rate,
                                                 bits=bits)
                grads_b = flash_mha_backward(q, k, v, qc, kc, out_b,
                                             lse_b, g, dropout_rate=rate,
                                             bits=bits)
                same = torch.equal(out_b, out) and all(
                    torch.equal(a, b) for a, b in zip(grads, grads_b))
                kept = (bits >= 26).float().mean().item()
                log(f"  dropout masks, in-kernel Philox vs plain bytes "
                    f"({tag}): {'bit-equal' if same else 'DIFFER'}; "
                    f"keep share {kept:.5f} (expected "
                    f"{1 - 26 / 256:.5f})")
                if not same:
                    raise RuntimeError("kernel dropout masks differ "
                                       "from the plain Philox bytes")


def train_batch(B, S, T, gen):
    import torch

    text_lens = torch.randint(S // 2, S + 1, (B,), generator=gen,
                              device="cuda")
    audio_lens = torch.randint(T // 2, T + 1, (B,), generator=gen,
                               device="cuda")
    text_lens[0], audio_lens[0] = S, T
    return {"text": torch.randint(3, 100, (B, S), generator=gen,
                                  device="cuda"),
            "text_lens": text_lens,
            "audio": torch.randint(0, 1024, (B, T, 8), generator=gen,
                                   device="cuda"),
            "audio_lens": audio_lens}


def with_impl(model, attn_impl, train_stage):
    """The model set to one attention route and its stage's remat."""
    from valle_tpu_torch.models import resolve_remat, resolve_score_bf16

    model.cfg = dataclasses.replace(
        model.cfg, attn_impl=attn_impl, remat=resolve_remat("auto",
                                                            train_stage),
        attn_score_bf16=resolve_score_bf16("auto"))
    return model


def check_train_step_fp32(info, label="", **cfg):
    """fp32, full width (``cfg`` overrides FULL), B=2, dropout off (no
    generator): one AR and one NAR step, flash kernels vs the einsum
    plain path from equal weights. Returns the flash runs' launches."""
    import torch

    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    from valle_tpu_torch.ops import cuda_build as cb

    gen = torch.Generator("cuda").manual_seed(31)
    base = VALLE(ValleConfig(**dict(FULL, **cfg)), generator=gen)
    batch = train_batch(2, AR_RECIPE["S"], AR_RECIPE["T"], gen)
    res, launches = {}, {n: 0 for n in ("flash_mha_fwd", "flash_mha_bwd")}
    for stage in (1, 2):
        out = {}
        for impl in ("flash", "einsum"):
            model = with_impl(copy.deepcopy(base), impl, stage)
            opt, lr_fn = make_optimizer(model, train_stage=stage)
            step = make_train_step(lr_fn, train_stage=stage)
            before = dict(cb.LAUNCHES)
            m = step(TrainState(model, opt), batch, 0)
            out[impl] = (m["loss"].item(), m["grad_norm"].item())
            ran = {n: cb.LAUNCHES[n] - before[n] for n in launches}
            if (min(ran.values()) > 0) != (impl == "flash"):
                raise RuntimeError(f"fp32 stage {stage} {impl}{label}: "
                                   f"flash launches {ran}")
            if impl == "flash":
                for n in launches:
                    launches[n] += ran[n]
            del model, opt
        rel_loss = abs(out["flash"][0] - out["einsum"][0]) / abs(
            out["einsum"][0])
        rel_norm = abs(out["flash"][1] - out["einsum"][1]) / abs(
            out["einsum"][1])
        ok = rel_loss <= 1e-5 and rel_norm <= 1e-4
        log(f"  fp32 stage {stage} step{label}, flash vs einsum: loss "
            f"{out['flash'][0]:.6f} vs {out['einsum'][0]:.6f} (rel "
            f"{rel_loss:.2e} <= 1e-5), grad_norm {out['flash'][1]:.6f} vs "
            f"{out['einsum'][1]:.6f} (rel {rel_norm:.2e} <= 1e-4) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"fp32 stage {stage}{label}: flash step "
                               "differs from the einsum step")
        res[f"stage{stage}"] = {"flash": out["flash"],
                                "einsum": out["einsum"],
                                "rel_loss": rel_loss,
                                "rel_grad_norm": rel_norm,
                                "flash_launches": launches}
    info["train_fp32_check" + label.replace(" ", "_")] = res
    del base
    torch.cuda.empty_cache()


def train_full_width(model, info, label=""):
    """Five bf16 steps per stage at the recipe shapes, dropout 0.1,
    through the kernels; launches counted from 0 for each stage."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    gen = torch.Generator("cuda").manual_seed(41)
    host_gen = torch.Generator().manual_seed(42)
    runs, launches = {}, {}
    for stage, shape, name in ((1, AR_RECIPE, "ar"), (2, NAR_RECIPE, "nar")):
        with_impl(model, "flash", stage)
        opt, lr_fn = make_optimizer(model, train_stage=stage)
        step = make_train_step(lr_fn, train_stage=stage,
                               compute_dtype=torch.bfloat16)
        state = TrainState(model, opt)
        batches = [train_batch(shape["B"], shape["S"], shape["T"], gen)
                   for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        outs = [step(state, b, 0, host_gen) for b in batches]
        torch.cuda.synchronize()
        launches[name] = dict(cb.LAUNCHES)
        losses = [o["loss"].item() for o in outs]
        norms = [o["grad_norm"].item() for o in outs]
        per_frame = [round(x / o["frames"].item(), 4)
                     for x, o in zip(losses, outs)]
        log(f"  {name}{label} stage {stage}, B={shape['B']} "
            f"S={shape['S']} T={shape['T']} remat {model.cfg.remat}, bf16, "
            f"dropout 0.1: loss/frame {per_frame}, "
            f"grad_norm {[round(x, 3) for x in norms]}, lr "
            f"{[round(o['lr'], 5) for o in outs]}, launches {launches[name]}")
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       losses + norms)):
            raise RuntimeError(f"{name}: non-finite loss or grad_norm")
        L = model.cfg.num_layers
        want_bwd = L * TRAIN_STEPS
        want_fwd = want_bwd * (2 if model.cfg.remat == "full" else 1)
        if (launches[name]["flash_mha_bwd"] != want_bwd
                or launches[name]["flash_mha_fwd"] != want_fwd):
            raise RuntimeError(f"{name}: flash launches {launches[name]}, "
                               f"expected fwd {want_fwd}, bwd {want_bwd}")
        runs[name] = {"loss": losses, "grad_norm": norms,
                      "frames": [o["frames"].item() for o in outs]}
        del opt, state
    key = label.replace(" ", "_")
    info["train_runs" + key] = runs
    info["launches_training" + key] = launches
    return launches


def time_train_steps(model, info):
    """ms/step flash vs einsum in turns (flash, einsum, einsum, flash),
    3 steps each after one untimed step, dropout 0.1; then the device busy
    share of one AR flash step."""
    import torch

    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    gen = torch.Generator("cuda").manual_seed(51)
    host_gen = torch.Generator().manual_seed(52)
    res = {}
    for stage, shape, name in ((1, AR_RECIPE, "ar"), (2, NAR_RECIPE, "nar")):
        batch = train_batch(shape["B"], shape["S"], shape["T"], gen)
        opt, lr_fn = make_optimizer(model, train_stage=stage)
        step = make_train_step(lr_fn, train_stage=stage,
                               compute_dtype=torch.bfloat16)
        state = TrainState(model, opt)
        times = {"flash": [], "einsum": []}
        for impl in ("flash", "einsum", "einsum", "flash"):
            with_impl(model, impl, stage)
            step(state, batch, 0, host_gen)
            torch.cuda.synchronize()
            for _ in range(3):
                t0 = time.perf_counter()
                step(state, batch, 0, host_gen)
                torch.cuda.synchronize()
                times[impl].append((time.perf_counter() - t0) * 1e3)
        res[name] = {k: {"runs_ms": v, "best_ms": min(v)}
                     for k, v in times.items()}
        res[name]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  train step {name} (B={shape['B']}, remat "
            f"{model.cfg.remat}, bf16): flash {min(times['flash']):.1f} "
            f"ms/step, einsum {min(times['einsum']):.1f} ms/step (runs "
            f"{[round(x, 1) for x in times['flash']]} / "
            f"{[round(x, 1) for x in times['einsum']]})")
        if stage == 1:
            with_impl(model, "flash", stage)

            def run():
                step(state, batch, 0, host_gen)
                torch.cuda.synchronize()

            prof = profile_busy(run, "trace_train_ar.json")
            log_busy("AR train step (flash, B=16)", prof)
            res["ar_profile"] = prof
        del opt, state
    info["train_ms"] = res


def time_train_kernels(times, bounds, library, H=16, Dh=64, key=""):
    """Flash forward and backward at the AR recipe's attention shape (H
    heads of Dh), bf16: kernel device time by CUDA-graph replay (dropout
    0.1 as trained, and 0); scaled_dot_product_attention with the boolean
    mask (timed here only, never on the port's path), like for like: at
    dropout 0 by replay (forward) and at dropout 0.1 from a profiler
    trace, its backward (and the plain versions: autograd inside) by
    traced_ms. ``library`` takes SDPA at dropout 0.1, the kernels'
    ``ms``; SDPA at dropout 0 goes to ``library[name + "_nodrop" +
    key]``."""
    import torch
    import torch.nn.functional as F

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops.flash_mha import (flash_mha_backward,
                                               flash_mha_forward,
                                               reference_mha,
                                               reference_mha_grads)

    gen = torch.Generator("cuda").manual_seed(61)
    B, S, T = AR_RECIPE["B"], AR_RECIPE["S"], AR_RECIPE["T"]
    q, k, v, g, qc, kc = attn_case(B, S, T, torch.bfloat16, gen, H=H, Dh=Dh)
    saved = dict(cb.LAUNCHES)
    fwd, bwd = "flash_mha_fwd", "flash_mha_bwd"
    for rate in (0.1, 0.0):
        kw = dict(dropout_rate=rate, seed=SEED if rate else None)
        out, lse = flash_mha_forward(q, k, v, qc, kc, **kw)
        sfx = ("" if rate else "_nodrop") + key
        times[fwd + sfx] = (
            min(graph_ms(lambda: flash_mha_forward(q, k, v, qc, kc, **kw))
                for _ in range(2)),
            traced_ms(lambda: reference_mha(q, k, v, qc, kc, **kw)))
        times[bwd + sfx] = (
            min(graph_ms(lambda: flash_mha_backward(q, k, v, qc, kc, out,
                                                    lse, g, **kw))
                for _ in range(2)),
            traced_ms(lambda: reference_mha_grads(q, k, v, qc, kc, g,
                                                  **kw)))
    cb.LAUNCHES.update(saved)
    vis = (kc[:, None, :] <= qc[:, :, None])[:, None]       # (B, 1, n, n)
    library[fwd + "_nodrop" + key] = min(graph_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vis))
        for _ in range(2))
    library[fwd + key] = traced_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vis,
                                               dropout_p=0.1), iters=20,
        label="SDPA forward, dropout 0.1")
    for rate, sfx in ((0.1, ""), (0.0, "_nodrop")):
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=vis,
                                                  dropout_p=rate)
        library[bwd + sfx + key] = traced_ms(
            lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g,
                                        retain_graph=True), iters=20,
            label=f"SDPA backward, dropout {rate}")
    n = q.shape[2]
    pairs = int(vis.sum()) * H                 # visible (b, h, i, j)
    tensor = B * H * n * Dh * 2                # one bf16 (B, H, n, Dh)
    lse_bytes = B * H * n * 4
    codes = 2 * B * n * 4
    bounds[fwd + key] = roofline(4 * tensor + lse_bytes + codes,
                                 4 * pairs * Dh)
    bounds[bwd + key] = roofline(8 * tensor + lse_bytes + codes,
                                 10 * pairs * Dh)
    skipped = skipped_tile_share(qc, kc)
    for name in (fwd, bwd):
        b = bounds[name + key]
        what = "forward" if name.endswith("fwd") else "backward"
        log(f"  {name}{key} (bf16, B={B} H={H} Dh={Dh} S=T={n}): kernel "
            f"device {times[name + key][0]:.4f} ms (dropout 0.1) vs "
            f"scaled_dot_product_attention {what} "
            f"{library[name + key]:.4f} ms (dropout 0.1, traced); kernel "
            f"{times[name + '_nodrop' + key][0]:.4f} ms (dropout 0) vs SDPA "
            f"{library[name + '_nodrop' + key]:.4f} ms (dropout 0); plain "
            f"{times[name + key][1]:.4f} ms; bound {b[0]:.4f} ms ({b[1]}); "
            f"visible pairs {pairs / (B * H * n * n):.3f}, key tiles "
            f"skipped {skipped:.3f}")


# ---------------------------------------------------------------------------
# phase 5e: the trainer on the card
# ---------------------------------------------------------------------------

# the seeded corpus: cuts of 2-8 s (150-600 frames at 75 Hz) of random
# codes with 20-100 char tokens each
TRAIN_CORPUS = dict(train=64, dev=8, frames=(150, 601), text=(20, 101))
# valle_tpu/bin/trainer.py:24-32's AR recipe, capped at 4 steps
# 5e's depth: d 1024 and 16 heads, 6 of FULL's 12 layers (cut to keep the
# whole smoke inside its time limit; every check runs as at 12)
TRAINER_LAYERS = 6
STAGE1_FLAGS = ["--max-duration", "80", "--prefix-mode", "1",
                "--train-stage", "1", "--num-epochs", "1",
                "--dtype", "bfloat16",
                "--max-steps-per-epoch", "4", "--save-every-n", "2",
                "--keep-last-k", "1", "--valid-interval", "4",
                "--tensorboard", "false"]
# the NAR stage from stage 1's epoch-1.pt, averaging every 2 steps; no
# step checkpoints (each file holds a float64 copy of the model)
STAGE2_FLAGS = ["--max-duration", "40", "--prefix-mode", "1",
                "--train-stage", "2", "--start-epoch", "2",
                "--num-epochs", "2", "--dtype", "bfloat16",
                "--max-steps-per-epoch", "4", "--save-every-n", "1000",
                "--valid-interval", "4", "--average-period", "2",
                "--tensorboard", "false"]
SYNTH_GEN = 64          # --max-gen-len of the synthesis from epoch-2.pt


class MemoryStore(dict):
    """A test double of the port's ``Hdf5FeatureStore`` for a machine
    without h5py: the corpora's codes in memory, read by key."""

    def read(self, key):
        return self[key]


_STORE = MemoryStore()     # every corpus of this process, keys prefixed


def write_train_corpus(root, sizes=None, prefix=""):
    """The seeded corpus under ``root`` (``sizes``, TRAIN_CORPUS by
    default; cut ids and keys ``{prefix}{split}_{i:03d}``): manifests
    ``cuts_{train,dev}.jsonl.gz`` and ``unique_text_tokens.k2symbols``;
    the codes in an HDF5 store where h5py imports, else in a MemoryStore
    that the port's ``manifests._cached_store`` is pointed at. Returns
    the store's kind."""
    import numpy as np

    from valle_tpu_torch.data import manifests
    from valle_tpu_torch.utils.symbol_table import SymbolTable

    sizes = sizes or TRAIN_CORPUS
    try:
        import h5py  # noqa: F401
        store = None
    except ImportError:
        store = _STORE
    rng = np.random.RandomState(SEED)
    letters = list("abcdefghijklmnopqrstuvwxyz_")
    frame_shift = 320.0 / 24000
    for split in ("train", "dev"):
        h5 = root / f"feats_{split}.h5"
        cuts, arrays = [], {}
        for i in range(sizes[split]):
            T = int(rng.randint(*sizes["frames"]))
            key = f"{prefix}{split}_{i:03d}"
            arrays[key] = rng.randint(0, 1024, (T, 8)).astype(np.int16)
            text = "".join(rng.choice(letters, rng.randint(*sizes["text"])))
            cuts.append(manifests.Cut(
                id=key, duration=T * frame_shift, text=text,
                tokens=list(text), speaker=f"spk{i % 4}",
                features=manifests.FeatureRef(str(h5), key, T, 8,
                                              frame_shift)))
        if store is None:
            with manifests.Hdf5FeatureStore(h5).writer() as w:
                for key, a in arrays.items():
                    w.write(key, a)
        else:
            store.update(arrays)
        manifests.CutSet(cuts).to_file(root / f"cuts_{split}.jsonl.gz")
    table = SymbolTable()
    for sym in ["<pad>", "<bos>", "<eos>"] + letters:
        table.add(sym)
    table.to_file(root / "unique_text_tokens.k2symbols")
    if store is None:
        return "hdf5"
    manifests._cached_store = lambda path: store
    return "memory (no h5py)"


def checkpoint_bytes(model):
    """About the bytes the two stages write (a run writes ~0.5% more:
    the average keeps tied weights twice): 5 stage-1 files of fp32
    weights + the AR ScaledAdam state (two buffers a parameter), 3
    stage-2 files of weights + the NAR state + the float64 average."""
    n = sum(p.numel() for p in model.parameters())
    n_ar = sum(p.numel() for name, p in model.named_parameters()
               if name.startswith("ar_"))
    return 5 * (4 * n + 8 * n_ar) + 3 * (4 * n + 8 * (n - n_ar) + 8 * n)


def run_trainer_stage(argv, name, card, phase_info):
    """``valle_tpu_torch.bin.trainer.run`` with ``argv``; counts set to 0
    before it and read after. Fails unless the flash pair launched
    exactly as the layers, the steps, the OOM scan's batches, the
    validation batches and the stage's remat say: backward once a layer
    and batch of a step or of the scan; forward as many times, twice
    under remat full, plus once a layer and validation batch."""
    import torch

    from valle_tpu_torch.bin import trainer
    from valle_tpu_torch.ops import cuda_build as cb

    torch.cuda.synchronize()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    stats = trainer.run(trainer.get_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = stats.state.model.cfg
    if cfg.attn_impl != "flash":
        raise RuntimeError(f"{name}: --attn-impl auto resolved to "
                           f"{cfg.attn_impl}, not flash")
    layers = cfg.num_layers
    bwd = layers * (stats.steps + stats.scan_batches)
    want = {"flash_mha_bwd": bwd,
            "flash_mha_fwd": (2 if cfg.remat == "full" else 1) * bwd
            + layers * stats.valid_batches}
    got = {k: cb.LAUNCHES[k] for k in want}
    ms = stats.loop_seconds / max(stats.steps, 1) * 1e3
    wait = stats.loader_wait_seconds / max(stats.loop_seconds, 1e-9)
    writes = [{"name": n, "s": sec, "bytes": b}
              for n, sec, b in stats.checkpoint_writes]
    phase_info[name] = {
        "wall_s": wall, "steps": stats.steps,
        "batch_shapes": stats.batch_shapes,
        "scan_batches": stats.scan_batches,
        "valid_batches": stats.valid_batches, "remat": cfg.remat,
        "ms_per_step": ms, "loader_wait_share": wait,
        "checkpoint_writes": writes, "launches": got, "expected": want,
        "resumed_from": stats.resumed_from,
        "optimizer_restored": stats.optimizer_restored}
    log(f"  {name}: {stats.steps} steps (rows, text, frames) "
        f"{stats.batch_shapes}, remat {cfg.remat}, OOM scan "
        f"{stats.scan_batches} batches, validation {stats.valid_batches} "
        f"batches, {wall:.1f} s in all; launches {got} (expected {want})")
    log(f"  {name}: trainer wall {ms:.1f} ms/step (the step loop, "
        f"validation and checkpoint writes excluded), loader wait "
        f"{100 * wait:.2f}% of it; {card}")
    for w in writes:
        log(f"  {name}: wrote {w['name']}.pt, {w['bytes'] / 2**30:.3f} GiB "
            f"in {w['s']:.2f} s ({w['bytes'] / 2**30 / w['s']:.2f} GiB/s); "
            f"{card}")
    if got != want:
        raise RuntimeError(f"{name}: flash launches {got}, expected {want}")
    return stats


def check_stage_switch(exp, stats2):
    """Stage 2 resumed from stage 1's epoch-1.pt with the optimizer state
    dropped (the new state covers the NAR parameters only), the AR
    parameters unmoved, and a float64 model average in epoch-2.pt."""
    import torch

    from valle_tpu_torch.models.valle import stage_params_mask
    from valle_tpu_torch.utils.checkpoint import load_checkpoint

    if (stats2.optimizer_restored
            or not str(stats2.resumed_from).endswith("epoch-1.pt")):
        raise RuntimeError(f"stage 2 resumed from {stats2.resumed_from} "
                           f"with the optimizer restored "
                           f"{stats2.optimizer_restored}")
    one = load_checkpoint(exp / "epoch-1.pt")
    two = load_checkpoint(exp / "epoch-2.pt")
    nar = [n for n, on in stage_params_mask(stats2.state.model, 2).items()
           if on]
    ar_same = all(torch.equal(v, two["model"][k])
                  for k, v in one["model"].items() if k.startswith("ar_"))
    nar_moved = [k for k in nar
                 if not torch.equal(one["model"][k], two["model"][k])]
    avg = two.get("model_avg")
    ok_avg = (avg is not None and avg.keys() == two["model"].keys()
              and all(v.dtype == torch.float64 for v in avg.values()))
    res = {"optimizer_entries": len(two["optimizer"]["state"]),
           "nar_params": len(nar), "ar_unmoved": ar_same,
           "nar_moved": len(nar_moved), "model_avg": ok_avg,
           "train_stage": two["train_stage"]}
    log(f"  stage switch 1 -> 2: {res}")
    if (res["optimizer_entries"] != len(nar) or not ar_same
            or not nar_moved or not ok_avg or two["train_stage"] != 2):
        raise RuntimeError(f"stage switch checks failed: {res}")
    return res


def synthesize_from_checkpoint(ckpt, d, card, phase_info):
    """``python -m valle_tpu_torch.bin.infer`` on the trained checkpoint,
    each run a subprocess that must exit 0: decode mode fused with at
    most SYNTH_GEN frames (its wav, if the AR does not stop at its first
    step, must be whole frames), and ``--continual true``, whose wav must
    hold the 113 frames after the 3 s prompt's 112-frame prefix."""
    import os

    import torch

    from valle_tpu_torch.data.tokenizer import AudioTokenizer

    torch.save(weight_normed(AudioTokenizer(device="cpu", seed=0)
                             .codec.state_dict()), d / "codec.th")
    prompt_wav(d / "p.wav", seed=0)
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "valle_tpu_torch.bin.infer",
           "--checkpoint", str(ckpt), "--encodec-weights",
           str(d / "codec.th"), "--text-extractor", "char",
           "--text-prompts", "a prompt", "--audio-prompts",
           str(d / "p.wav"), "--text", TEXTS[0], "--top-k", "10",
           "--max-gen-len", str(SYNTH_GEN), "--decode-mode", "fused"]
    torch.cuda.empty_cache()
    res = {}
    for name, extra, want in (("fused", [], None),
                              ("continual", ["--continual", "true"], 113)):
        t0 = time.perf_counter()
        run = subprocess.run(
            cmd + extra + ["--output-dir", str(d / name)], cwd=str(root),
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(root)))
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise RuntimeError(f"bin.infer ({name}) on {ckpt.name} exited "
                               f"{run.returncode}:\n{run.stderr[-3000:]}")
        wav = d / name / "0.wav"
        if wav.exists() or want is not None:
            frames = check_wav(wav, want)
        elif "empty generation" in run.stderr:
            frames = 0
        else:
            raise RuntimeError(f"bin.infer ({name}) wrote no wav")
        if frames > SYNTH_GEN and want is None:
            raise RuntimeError(f"bin.infer ({name}) gave {frames} frames")
        res[name] = {"frames": frames, "wall_s": wall}
        log(f"  bin.infer --checkpoint {ckpt.name} --decode-mode fused"
            f"{' --continual true' if extra else ''}: {frames} frames"
            f"{' (the AR stopped at its first step)' if not frames else ''}"
            f", {wall:.1f} s (a fresh process: load, encode, synthesize, "
            f"write); {card}")
    phase_info["synthesis"] = res


def train_with_the_cli(card, info):
    """Phase 5e: a seeded corpus in a temporary directory (removed at
    exit), the trainer at full width (TRAINER_LAYERS deep) through stage 1
    and a stage-switch
    resume into stage 2, then synthesis from the stage-2 checkpoint."""
    import torch

    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    atexit.register(shutil.rmtree, d, True)
    corpus, exp = d / "corpus", d / "exp"
    corpus.mkdir()
    kind = write_train_corpus(corpus)
    log(f"  feature store: {kind}")
    with torch.device("meta"):
        need = checkpoint_bytes(VALLE(ValleConfig(**dict(
            FULL, num_layers=TRAINER_LAYERS))))
    free = shutil.disk_usage(d).free
    log(f"  checkpoints will take about {need / 2**30:.1f} GiB; "
        f"{free / 2**30:.1f} GiB free")
    if free < 1.2 * need:
        raise RuntimeError("not enough disk for the trainer's checkpoints")
    common = ["--manifest-dir", str(corpus), "--text-tokens",
              str(corpus / "unique_text_tokens.k2symbols"), "--exp-dir",
              str(exp), "--decoder-dim", str(FULL["d_model"]), "--nhead",
              str(FULL["nhead"]), "--num-decoder-layers",
              str(TRAINER_LAYERS), "--attn-impl", "auto"]
    phase = {"feature_store": kind, "checkpoint_bytes_estimate": need,
             "disk_free": free, "card": card}
    info["trainer"] = phase
    stats1 = run_trainer_stage(common + STAGE1_FLAGS, "stage1", card, phase)
    del stats1
    torch.cuda.empty_cache()
    stats2 = run_trainer_stage(common + STAGE2_FLAGS, "stage2", card, phase)
    phase["stage_switch"] = check_stage_switch(exp, stats2)
    del stats2
    torch.cuda.empty_cache()
    synthesize_from_checkpoint(exp / "epoch-2.pt", d, card, phase)
    bare = info["train_ms"]
    log(f"  beside phase 5d's bare steps (12 layers; B 16 S 96 T 375 AR "
        f"remat full, B 8 NAR remat none): AR "
        f"{bare['ar']['flash']['best_ms']:.1f} / NAR "
        f"{bare['nar']['flash']['best_ms']:.1f} ms/step; trainer "
        f"({TRAINER_LAYERS} layers) stage 1 "
        f"{phase['stage1']['ms_per_step']:.1f} / stage 2 "
        f"{phase['stage2']['ms_per_step']:.1f} ms/step; {card}")
    shutil.rmtree(d, ignore_errors=True)
    return {n: phase["stage1"]["launches"][n] + phase["stage2"]["launches"][n]
            for n in ("flash_mha_fwd", "flash_mha_bwd")}


# ---------------------------------------------------------------------------
# phase 5f: sequence-packed training
# ---------------------------------------------------------------------------

# cuts like 5e's, enough for 5 packed batches of 8 rows (the last one with
# empty rows)
PACK_CORPUS = dict(train=110, dev=4, frames=(150, 601), text=(20, 101))
PACK_PREFIX = "pack_"
PACK = dict(rows=8, frames=1024, text=256)   # the JAX trainer's defaults
PACK_COMMON = ["--model-name", "valle", "--prefix-mode", "1",
               "--dtype", "bfloat16", "--max-steps-per-epoch", "4",
               "--save-every-n", "1000", "--valid-interval", "1000",
               "--tensorboard", "false",
               "--pack-max-frames", str(PACK["frames"]),
               "--pack-max-text", str(PACK["text"]),
               "--pack-rows", str(PACK["rows"])]
PACK_STAGE1 = PACK_COMMON + ["--ar-pack", "true", "--train-stage", "1",
                             "--remat", "full", "--num-epochs", "1"]
# stage 2 resumes from stage 1's epoch-1.pt (a stage switch)
PACK_STAGE2 = PACK_COMMON + ["--nar-pack", "true", "--train-stage", "2",
                             "--remat", "none", "--start-epoch", "2",
                             "--num-epochs", "2"]


def packed_corpus():
    """PACK_CORPUS in a temporary directory (removed at exit); returns
    its root."""
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_pack_"))
    atexit.register(shutil.rmtree, d, True)
    write_train_corpus(d, PACK_CORPUS, PACK_PREFIX)
    return d


def packed_batches(corpus, n=1):
    """The first ``n`` batches of the packing sampler over the corpus (8
    rows of 1024 frames and 256 tokens, the sampler's seed and epoch 0),
    as (AR, NAR) batch dicts of numpy arrays, and the rows of cuts."""
    from valle_tpu_torch.data.collation import get_text_token_collater
    from valle_tpu_torch.data.manifests import CutSet
    from valle_tpu_torch.data.packing import (PackedNarSpeechDataset,
                                              PackedSpeechDataset,
                                              SequencePackingSampler)

    cuts = CutSet.from_file(corpus / "cuts_train.jsonl.gz")
    sampler = SequencePackingSampler(
        cuts, max_frames=PACK["frames"], max_text=PACK["text"],
        rows_per_batch=PACK["rows"])
    collater = get_text_token_collater(
        str(corpus / "unique_text_tokens.k2symbols"))
    out = []
    for _, b in zip(range(n), sampler):
        kw = dict(pad_audio_to=b.pad_audio_to, pad_text_to=b.pad_text_to)
        ar = PackedSpeechDataset(collater).__getitem__(b.cuts, **kw)
        nar = PackedNarSpeechDataset(collater).__getitem__(b.cuts, **kw)
        for batch in (ar, nar):
            batch.pop("utt_id")
        out.append((ar, nar, b.cuts))
    return out


def tile_shares(qc, kc, qs, ks, tile=64):
    """Of the (query tile, key tile) pairs of 64 x 64 of a packed batch:
    the share the flash kernels visit (their skip list works from the
    codes alone) and the share that holds a visible pair (same segment,
    code rule, or the diagonal)."""
    import torch

    B, St = qc.shape
    n = -(-St // tile)
    visible = ((kc[:, None, :] <= qc[:, :, None])
               & (qs[:, :, None] == ks[:, None, :]))
    visible |= torch.eye(St, dtype=torch.bool, device=qc.device)[None]
    pad = n * tile - St
    visible = torch.nn.functional.pad(visible, (0, pad, 0, pad))
    needed = visible.view(B, n, tile, n, tile).any(4).any(2)
    return 1.0 - skipped_tile_share(qc, kc, tile), needed.float().mean().item()


def check_packed_kernels(errs, corpus, info):
    """5a at the packed shape: B 8, H 16, S = T = 1280, the segments of the
    sampler's first batch with its last row emptied, AR and NAR codes,
    fp32 and bf16, dropout 0 and 0.1 (``check_flash_cases``), with the
    cotangent zero at the padded positions, as on the path: no query and
    no loss reads them. Then, logged only, the bf16 dq error at dropout
    0.1 with a cotangent there too, on the padded rows (each sees its own
    key alone) and on the rest; and the share of key tiles B4 visits."""
    import torch

    from valle_tpu_torch.ops import masks as M
    from valle_tpu_torch.ops.flash_mha import (flash_mha_backward,
                                               flash_mha_forward,
                                               reference_mha_grads)

    ar, _, rows = packed_batches(corpus)[0]
    empty = {k: v.copy() for k, v in ar.items()}
    for k in ("text_seg", "audio_seg"):
        empty[k][-1] = -1
    segs = [torch.as_tensor(empty[k], device="cuda")
            for k in ("text_seg", "audio_seg")]
    codes = {"packed ar": M.flash_codes_packed_ar(*segs),
             "packed nar": M.flash_codes_packed_nar(*segs)}
    pad = torch.cat(segs, dim=1) < 0                      # (B, S+T)
    gen = torch.Generator("cuda").manual_seed(23)
    B, St = pad.shape
    res = {"segments_per_row": [len(r) for r in rows[:-1]] + [0],
           "padded_positions": int(pad.sum())}
    for dt in (torch.float32, torch.bfloat16):
        limit = FP32_LIMIT if dt == torch.float32 else BF16_LIMIT
        cases = {}
        for name, (qc, kc, qs, ks) in codes.items():
            q, k, v, g = (torch.randn(B, 16, St, 64, generator=gen,
                                      device="cuda").to(dt)
                          for _ in range(4))
            cases[name] = (q, k, v, g.masked_fill(pad[:, None, :, None], 0),
                           qc, kc, dict(qseg=qs, kseg=ks, add_diag=True))
            if dt == torch.bfloat16:
                seg = cases[name][-1]
                kw = dict(seg, dropout_rate=0.1, seed=SEED)
                out, lse = flash_mha_forward(q, k, v, qc, kc, **kw)
                dq = flash_mha_backward(q, k, v, qc, kc, out, lse, g, **kw)[0]
                ref = reference_mha_grads(q, k, v, qc, kc, g, **kw)[0]
                err = (dq.float() - ref.float()).abs().amax(dim=(1, 3))
                scale = ref.float().abs().max().item()
                split = {"padded": err[pad].max().item() / scale,
                         "others": err[~pad].max().item() / scale}
                res[name + " bf16 dq error, cotangent everywhere"] = split
                log(f"  {name} bf16 dropout 0.1, a cotangent on the padded "
                    f"rows too (logged, not gated): dq error "
                    f"{split['padded']:.3e} there (one visible key), "
                    f"{split['others']:.3e} elsewhere, of the largest |dq|")
                del out, lse, dq, ref
        check_flash_cases(cases, dt, limit, errs, "", 64)
        del cases
    for name, (qc, kc, qs, ks) in codes.items():
        visited, needed = tile_shares(qc, kc, qs, ks)
        res[name] = {"visited": visited, "needed": needed}
        log(f"  B4 at the packed shape (B {B}, S = T = {St}, {name} codes, "
            f"last row empty): visits {visited:.4f} of the 64 x 64 key "
            f"tiles; {needed:.4f} hold a visible pair")
    info["packed_tiles"] = res
    torch.cuda.synchronize()


def padding_shares(cuts):
    """Padding shares over an epoch of ``cuts``: the packing sampler's rows
    against the bucketing sampler's batches (5e's --max-duration 80, 10
    buckets), in audio frames and in all [text; audio] positions."""
    from valle_tpu_torch.data.packing import SequencePackingSampler
    from valle_tpu_torch.data.sampler import DynamicBucketingSampler

    def share(batches, rows_of):
        real_f = real_p = slot_f = slot_p = 0
        for b in batches:
            rows = rows_of(b)
            for cut in [c for row in rows for c in row]:
                real_f += cut.features.num_frames
                real_p += cut.features.num_frames + len(cut.tokens) + 2
            slot_f += len(rows) * b.pad_audio_to
            slot_p += len(rows) * (b.pad_audio_to + b.pad_text_to)
        return {"frames": 1 - real_f / slot_f,
                "positions": 1 - real_p / slot_p, "batches": len(batches)}

    packed = share(list(SequencePackingSampler(
        cuts, max_frames=PACK["frames"], max_text=PACK["text"],
        rows_per_batch=PACK["rows"])), lambda b: b.cuts)
    bucketed = share(list(DynamicBucketingSampler(
        cuts, max_duration=80, num_buckets=10, quadratic_duration=10.0)),
        lambda b: [[c] for c in b.cuts])
    return {"packed": packed, "bucketed": bucketed}


def synthetic_cuts(n):
    """``n`` cuts drawn as PACK_CORPUS's (frames and token counts), with
    no codes: enough for the samplers."""
    import numpy as np

    from valle_tpu_torch.data.manifests import Cut, CutSet, FeatureRef

    rng = np.random.RandomState(SEED + 1)
    cuts = []
    for i in range(n):
        T = int(rng.randint(*PACK_CORPUS["frames"]))
        cuts.append(Cut(id=f"synthetic_{i:05d}", duration=T * 320 / 24000,
                        text="", tokens=["a"] * int(
                            rng.randint(*PACK_CORPUS["text"])),
                        features=FeatureRef("", "", T, 8, 320 / 24000)))
    return CutSet(cuts)


def check_packed_fp32(corpus, info):
    """fp32, full width, dropout off (no generator): one packed AR step
    and one packed NAR step on the sampler's first batch, flash kernels
    against the einsum path from equal weights (loss within 1e-5
    relative, grad_norm within 1e-4); then the packed AR loss of row 0
    through the kernels against the sum of its segments' exact-length
    unpacked forwards (1e-5 relative)."""
    import torch

    from valle_tpu_torch.data.collation import get_text_token_collater
    from valle_tpu_torch.models.valle import (VALLE, ValleConfig,
                                              valle_ar_forward_packed,
                                              valle_forward,
                                              valle_nar_forward_packed)
    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    ar, nar, rows = packed_batches(corpus)[0]
    base = VALLE(ValleConfig(**FULL),
                 generator=torch.Generator("cuda").manual_seed(37))
    res = {}
    for stage, fwd, batch in ((1, valle_ar_forward_packed, ar),
                              (2, valle_nar_forward_packed, nar)):
        out = {}
        for impl in ("flash", "einsum"):
            model = with_impl(copy.deepcopy(base), impl, stage)
            opt, lr_fn = make_optimizer(model, train_stage=stage)
            step = make_train_step(lr_fn, train_stage=stage, forward_fn=fwd)
            m = step(TrainState(model, opt), batch, 0)
            out[impl] = (m["loss"].item(), m["grad_norm"].item())
            del model, opt
        rel_loss = abs(out["flash"][0] - out["einsum"][0]) / abs(
            out["einsum"][0])
        rel_norm = abs(out["flash"][1] - out["einsum"][1]) / abs(
            out["einsum"][1])
        ok = rel_loss <= 1e-5 and rel_norm <= 1e-4
        log(f"  fp32 packed stage {stage} step ({PACK['rows']} rows of "
            f"{PACK['text']} + {PACK['frames']}), "
            f"flash vs einsum: loss {out['flash'][0]:.6f} vs "
            f"{out['einsum'][0]:.6f} (rel {rel_loss:.2e} <= 1e-5), "
            f"grad_norm {out['flash'][1]:.6f} vs {out['einsum'][1]:.6f} "
            f"(rel {rel_norm:.2e} <= 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"fp32 packed stage {stage}: the flash step "
                               "differs from the einsum step")
        res[f"stage{stage}"] = {"flash": out["flash"],
                                "einsum": out["einsum"],
                                "rel_loss": rel_loss,
                                "rel_grad_norm": rel_norm}
    model = with_impl(base, "flash", 1).eval()
    collater = get_text_token_collater(
        str(corpus / "unique_text_tokens.k2symbols"))
    with torch.no_grad():
        row = {k: torch.as_tensor(v[:1], device="cuda")
               for k, v in ar.items()}
        packed = valle_ar_forward_packed(model, row,
                                         deterministic=True)[0].item()
        parts = []
        for cut in rows[0]:
            ids, lens = collater.index([cut.tokens])
            codes = cut.load_features().astype("int64")
            one = {"text": torch.as_tensor(ids, device="cuda"),
                   "text_lens": torch.as_tensor(lens, device="cuda"),
                   "audio": torch.as_tensor(codes, device="cuda")[None],
                   "audio_lens": torch.tensor([len(codes)], device="cuda")}
            parts.append(valle_forward(model, one, train_stage=1,
                                       deterministic=True)[1]["ar_loss"]
                         .item())
    rel = abs(packed - sum(parts)) / abs(sum(parts))
    log(f"  fp32 packed AR row 0 ({len(parts)} segments) through the "
        f"kernels: loss {packed:.6f} vs the sum of its exact-length "
        f"forwards {sum(parts):.6f} (rel {rel:.2e} <= 1e-5) "
        f"{'ok' if rel <= 1e-5 else 'FAIL'}")
    if rel > 1e-5:
        raise RuntimeError("the packed row's loss is not the sum of its "
                           "segments' losses")
    res["row0"] = {"packed": packed, "segments": parts, "rel": rel}
    info["packed_fp32_check"] = res
    del base, model
    torch.cuda.empty_cache()


def train_packed_with_the_cli(corpus, card, info):
    """Phase 5f: ``bin/trainer.py run`` at full width, bf16, on the packed
    corpus: --ar-pack (stage 1, remat full), then --nar-pack (stage 2,
    prefix mode 1, remat none) from stage 1's epoch-1.pt. The flash
    pair's launches as ``run_trainer_stage`` counts them; losses finite.
    best-train-loss writes are skipped (recorded) so the phase writes two
    checkpoints, epoch-1.pt and epoch-2.pt."""
    import math

    from valle_tpu_torch.bin import trainer

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_pack_exp_"))
    atexit.register(shutil.rmtree, exp, True)
    common = ["--manifest-dir", str(corpus), "--text-tokens",
              str(corpus / "unique_text_tokens.k2symbols"), "--exp-dir",
              str(exp), "--decoder-dim", str(FULL["d_model"]), "--nhead",
              str(FULL["nhead"]), "--num-decoder-layers",
              str(FULL["num_layers"]), "--attn-impl", "auto"]
    from valle_tpu_torch.data.manifests import CutSet

    # the padding of the 5f corpus, and of 4000 such cuts: the packer
    # keeps up to 32 rows open, so a corpus of a few dozen rows ends with
    # most of them half full
    phase = {"card": card, "padding": {
        "corpus": padding_shares(CutSet.from_file(
            corpus / "cuts_train.jsonl.gz")),
        "4000 cuts": padding_shares(synthetic_cuts(4000))}}
    info["packed_trainer"] = phase
    for where, shares in phase["padding"].items():
        for name, pad in shares.items():
            log(f"  padding share over an epoch of {where}, {name}: "
                f"{pad['frames']:.4f} of the audio frames, "
                f"{pad['positions']:.4f} of all [text; audio] positions "
                f"({pad['batches']} batches)")
    save, skipped = trainer.save_checkpoint, []

    def fewer_writes(exp_dir, name, *a, **k):
        if name.startswith("best-"):
            skipped.append(name)
            return None
        return save(exp_dir, name, *a, **k)

    trainer.save_checkpoint = fewer_writes
    try:
        launches = {}
        for name, flags in (("packed_stage1", PACK_STAGE1),
                            ("packed_stage2", PACK_STAGE2)):
            stats = run_trainer_stage(common + flags, name, card, phase)
            losses = [loss / max(frames, 1)
                      for loss, frames, _ in stats.step_metrics]
            phase[name]["loss_per_frame"] = losses
            log(f"  {name}: loss/frame {[round(x, 4) for x in losses]}")
            if len(losses) != stats.steps or not all(map(math.isfinite,
                                                          losses)):
                raise RuntimeError(f"{name}: losses {losses}")
            launches[name] = phase[name]["launches"]
            del stats
    finally:
        trainer.save_checkpoint = save
    phase["skipped_writes"] = skipped
    shutil.rmtree(exp, ignore_errors=True)
    return {n: sum(run[n] for run in launches.values())
            for n in ("flash_mha_fwd", "flash_mha_bwd")}


# ---------------------------------------------------------------------------
# phase 5g: data parallel
# ---------------------------------------------------------------------------

DP_FLAGS = ["--model-name", "valle", "--prefix-mode", "1",
            "--train-stage", "0", "--max-duration", "80",
            "--num-epochs", "1", "--max-steps-per-epoch", "3",
            "--save-every-n", "1000", "--valid-interval", "1000",
            "--oom-check", "false", "--tensorboard", "false"]
# the fp32 comparison's runs. ScaledAdam's first update moves each element
# by about lr x its tensor's RMS whatever the gradient's size, so an
# element whose gradient changes sign with the reduction's order moves
# 2 lr the other way: 2e-2 after 3 steps at the recipe's lr (0.05 x 0.5
# in warmup) on an H100. At 1e-5 that stays under the 1e-4 the parameters
# are held to, while the losses and gradient norms are compared as they
# are.
DP_FP32 = ["--dtype", "float32", "--base-lr", "1e-5"]
# 5g's depth: d 1024 and 16 heads, 4 of FULL's 12 layers (cut to keep the
# whole smoke inside its time limit; every check runs as at 12)
DP_LAYERS = 4
DP_ENV = "CHIP_SMOKE_DP_JOB"     # set: this process is one rank of a job


def drop_dropout_seeds():
    """Patch the forwards to draw their dropout seeds and then drop them:
    dropout 0, with the NAR stage and prefix draws unchanged. Returns the
    restorer."""
    from valle_tpu_torch.models import valle

    draw = valle._draw_seeds
    valle._draw_seeds = (lambda generator, training, batch, n=8:
                         [None] * len(draw(generator, training, batch, n)))
    return lambda: setattr(valle, "_draw_seeds", draw)


def two_rank_batches():
    """Patch the trainer to round each batch as two ranks do (to an even
    number of rows), so one process trains on the two ranks' global
    batches. Returns the restorer."""
    from valle_tpu_torch.bin import trainer

    grouped = trainer._model_batch
    trainer._model_batch = lambda batch, accum, dp=1: grouped(batch, accum,
                                                              2)
    return lambda: setattr(trainer, "_model_batch", grouped)


def no_checkpoint_bytes():
    """Patch the checkpoint writer to write nothing (the trainer still
    records each save's name): 5g's runs would otherwise write ~4.4 GB a
    file. Returns the restorer."""
    from valle_tpu_torch.bin import trainer

    write = trainer.ckpt_lib.save_checkpoint
    trainer.ckpt_lib.save_checkpoint = lambda path, **kw: 0
    return lambda: setattr(trainer.ckpt_lib, "save_checkpoint", write)


def state_digest(model):
    """sha256 over the state dict's names and bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, v in model.state_dict().items():
        h.update(name.encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def dp_worker(job_path):
    """One rank of a 5g job (``torchrun`` started this process with DP_ENV
    pointing at the job): ``bin/trainer.py run`` with the job's argv,
    launches counted, each gradient all-reduce timed; writes
    ``rank<r>.json`` beside the job file."""
    import os

    import torch

    job = json.loads(Path(job_path).read_text())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from valle_tpu_torch.bin import trainer
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cb.load_library()
    try:
        import h5py  # noqa: F401
    except ImportError:     # the parent's codes were in its memory
        d = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
        atexit.register(shutil.rmtree, d, True)
        write_train_corpus(d, PACK_CORPUS, PACK_PREFIX)
    restore = [no_checkpoint_bytes()]
    if not job["dropout"]:
        restore.append(drop_dropout_seeds())
    reduce, timed = mesh.all_reduce_gradients, []

    def timed_reduce(params, extra=()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(params, extra)
        torch.cuda.synchronize()
        nbytes = sum(p.numel() * p.element_size() for p in params)
        timed.append((time.perf_counter() - t0, nbytes + 4 * len(extra)))
        return out

    mesh.all_reduce_gradients = timed_reduce
    cb.reset_launch_counts()
    try:
        stats = trainer.run(trainer.get_parser().parse_args(job["argv"]))
    finally:
        mesh.all_reduce_gradients = reduce
        for r in restore:
            r()
    rank = int(os.environ["RANK"])
    model = stats.state.model
    res = {"rank": rank, "world": int(os.environ["WORLD_SIZE"]),
           "device": str(next(model.parameters()).device),
           "step_metrics": stats.step_metrics, "steps": stats.steps,
           "batch_shapes": stats.batch_shapes,
           "writes": [w[0] for w in stats.checkpoint_writes],
           "launches": {k: cb.LAUNCHES[k]
                        for k in ("flash_mha_fwd", "flash_mha_bwd")},
           "layers": model.cfg.num_layers + model.cfg.nar_num_layers,
           "remat": model.cfg.remat, "attn_impl": model.cfg.attn_impl,
           "reduce": timed, "loop_s": stats.loop_seconds,
           "digest": state_digest(model)}
    if rank == 0 and job.get("reference"):
        ref = torch.load(job["reference"],
                         map_location=next(model.parameters()).device)
        worst, excess = 0.0, 0.0
        for k, v in model.state_dict().items():
            d = (v.float() - ref[k].float()).abs()
            worst = max(worst, d.max().item())
            excess = max(excess, (d - 1e-4 * ref[k].float().abs())
                         .max().item())
        res["param_max_abs_diff"], res["param_excess"] = worst, excess
    Path(job["out"]).joinpath(f"rank{rank}.json").write_text(
        json.dumps(res))
    return 0


def torchrun(nproc, job, d, timeout=600):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc chip_smoke.py`` with the job in the environment, in a session
    of its own (killed whole on a timeout); returns the ranks' results."""
    import os
    import signal

    path = d / f"{job['name']}.json"
    job = dict(job, out=str(d))
    path.write_text(json.dumps(job))
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), str(Path(__file__).resolve())]
    env = dict(os.environ, PYTHONPATH=str(root), **{DP_ENV: str(path)})
    for r in range(nproc):
        d.joinpath(f"rank{r}.json").unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(root), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{job['name']}: torchrun timed out")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{job['name']}: torchrun exited "
                           f"{proc.returncode}:\n{out[-6000:]}")
    return wall, [json.loads(d.joinpath(f"rank{r}.json").read_text())
                  for r in range(nproc)]


def log_reduce(name, ranks, card):
    for r in ranks:
        if r["reduce"]:
            secs = [s for s, _ in r["reduce"]]
            log(f"  {name} rank {r['rank']}: gradient all-reduce "
                f"{r['reduce'][0][1] / 1e9:.3f} GB a step in "
                f"{[round(s, 3) for s in secs]} s; {card}")


def check_dp_launches(name, ranks):
    for r in ranks:
        bwd = r["layers"] * r["steps"]
        want = {"flash_mha_bwd": bwd,
                "flash_mha_fwd": (2 if r["remat"] == "full" else 1) * bwd}
        if r["attn_impl"] != "flash" or r["launches"] != want:
            raise RuntimeError(f"{name} rank {r['rank']}: {r['attn_impl']} "
                               f"launches {r['launches']}, expected {want}")


def train_data_parallel(corpus, card, info):
    """Phase 5g: two ranks on the one card over gloo (``--dp-share-device
    true``), launched by torchrun, at full width cut to DP_LAYERS layers
    on stage 0 (both decoders, prefix mode 1): at fp32 with dropout off
    (lr 1e-5, see DP_FP32), 3 steps whose losses equal a one-process run's on the same
    global batches (1e-5 relative), gradient norms too (1e-4: a sum, not
    a mean), parameters within 1e-4 of it, the ranks bit-equal and rank 0
    alone saving; at bf16 with dropout 0.1, finite losses, the ranks
    bit-equal and the flash pair launched as counted on each rank; then
    one rank over NCCL. Checkpoint bytes are not written (the saves
    recorded); the all-reduce's seconds and bytes are logged."""
    import math

    import torch

    from valle_tpu_torch.bin import trainer

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    atexit.register(shutil.rmtree, d, True)
    common = ["--manifest-dir", str(corpus), "--text-tokens",
              str(corpus / "unique_text_tokens.k2symbols"),
              "--decoder-dim", str(FULL["d_model"]), "--nhead",
              str(FULL["nhead"]), "--num-decoder-layers",
              str(DP_LAYERS), "--attn-impl", "auto"] + DP_FLAGS
    phase = {"card": card}
    info["data_parallel"] = phase

    # the one-process reference on the same global batches, fp32, dropout
    # off
    restore = [no_checkpoint_bytes(), drop_dropout_seeds(),
               two_rank_batches()]
    try:
        t0 = time.perf_counter()
        one = trainer.run(trainer.get_parser().parse_args(
            common + ["--exp-dir", str(d / "one")] + DP_FP32))
        torch.cuda.synchronize()
        phase["one_process_fp32"] = {"step_metrics": one.step_metrics,
                                     "wall_s": time.perf_counter() - t0,
                                     "batch_shapes": one.batch_shapes}
    finally:
        for r in restore:
            r()
    torch.save(one.state.model.state_dict(), d / "one.pt")
    del one
    torch.cuda.empty_cache()

    share = ["--world-size", "2", "--dp-share-device", "true"]
    runs = (("gloo_fp32", 2, share + DP_FP32, False),
            ("gloo_bf16", 2, share + ["--dtype", "bfloat16"], True),
            ("nccl_bf16", 1, ["--world-size", "1", "--dtype", "bfloat16"],
             True))
    for name, nproc, flags, dropout in runs:
        job = {"name": name, "dropout": dropout,
               "argv": common + ["--exp-dir", str(d / name)] + flags,
               "reference": str(d / "one.pt") if name == "gloo_fp32"
               else None}
        wall, ranks = torchrun(nproc, job, d)
        phase[name] = {"wall_s": wall, "ranks": ranks}
        losses = [[loss / max(f, 1) for loss, f, _ in r["step_metrics"]]
                  for r in ranks]
        log(f"  {name}: {nproc} rank(s) on {ranks[0]['device']}, "
            f"{ranks[0]['steps']} steps (rows a rank, text, frames) "
            f"{ranks[0]['batch_shapes']}, loss/frame "
            f"{[round(x, 5) for x in losses[0]]}, launches "
            f"{[r['launches'] for r in ranks]}, {wall:.1f} s under torchrun")
        log_reduce(name, ranks, card)
        if not all(math.isfinite(x) for ls in losses for x in ls):
            raise RuntimeError(f"{name}: non-finite losses {losses}")
        if len({r["digest"] for r in ranks}) != 1:
            raise RuntimeError(f"{name}: the ranks' parameters differ")
        if any(r["writes"] for r in ranks[1:]) or not ranks[0]["writes"]:
            raise RuntimeError(f"{name}: saves {[r['writes'] for r in ranks]}"
                               ", expected rank 0's alone")
        check_dp_launches(name, ranks)
        if name == "gloo_fp32":
            want = phase["one_process_fp32"]["step_metrics"]
            rel = [max(abs(a[i] - b[i]) / abs(b[i]) for r in ranks
                       for a, b in zip(r["step_metrics"], want))
                   for i in (0, 2)]
            same_len = all(len(r["step_metrics"]) == len(want)
                           for r in ranks)
            r0 = ranks[0]
            ok = (same_len and rel[0] <= 1e-5 and rel[1] <= 1e-4
                  and r0["param_excess"] <= 1e-4)
            log(f"  gloo_fp32 vs one process: step losses rel {rel[0]:.2e} "
                f"<= 1e-5, grad norms rel {rel[1]:.2e} <= 1e-4 (a sum over "
                f"the ranks, not a mean), parameters max |diff| "
                f"{r0['param_max_abs_diff']:.2e} (excess over 1e-4 * |p| "
                f"{r0['param_excess']:.2e} <= 1e-4), ranks bit-equal "
                f"{'ok' if ok else 'FAIL'}")
            phase[name]["rel_loss"], phase[name]["rel_grad_norm"] = rel
            if not ok:
                raise RuntimeError("two ranks do not train what one "
                                   "process trains")
    shutil.rmtree(d, ignore_errors=True)
    return {n: sum(r["launches"][n] for run in runs
                   for r in phase[run[0]]["ranks"])
            for n in ("flash_mha_fwd", "flash_mha_bwd")}


# ---------------------------------------------------------------------------
# phase 6: continuous batching and the HTTP server
# ---------------------------------------------------------------------------

CB = dict(slots=8, text_pad=64, prompt_pad=256, max_gen_len=512, chunk=64)
CB_FP32_GEN = 64        # 6a's budget
CB_REQUESTS = 24        # 6b's requests, 225-frame prompts
SERVE_FLAGS = ["--text-backend", "char", "--host", "127.0.0.1", "--port",
               "0", "--top-k", "1", "--text-pad", str(CB["text_pad"]),
               "--max-gen-len", str(CB["max_gen_len"]),
               "--request-timeout-s", "600"]


def cb_texts(n, seed, lo=2, hi=30):
    """n seeded texts of lo..hi characters: letters, and single spaces
    inside."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(lo, hi + 1)
        s = "".join("abcdefghijklmnopqrstuvwxyz"[rng.randint(26)]
                    for _ in range(k))
        cut = [j for j in range(2, k - 1, 5)]      # a space every 5
        out.append("".join(" " if j in cut else c for j, c in enumerate(s)))
    return out


def cb_engine(model, audio_tok, dtype, **kw):
    """A ContinuousBatcher at CB's shape, greedy (``kw`` overrides)."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import TextTokenizer
    from valle_tpu_torch.serving import ContinuousBatcher

    args = dict(CB, top_k=1, compute_dtype=dtype, seed=1, device="cuda",
                codec_dtype="bfloat16", wav_transfer="pcm16")
    args.update(kw)
    return ContinuousBatcher(model, TextTokenizer(backend="char"),
                             TextTokenCollater(
                                 sorted(set("abcdefghijklmnopqrstuvwxyz_"))),
                             audio_tok, **args)


def static_engine(model, audio_tok, dtype, decode_mode, max_gen_len, **kw):
    """The Synthesizer with cb_engine's sampling and codec settings
    (``kw``: more of its arguments, e.g. a mesh)."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import TextTokenizer
    from valle_tpu_torch.serving import Synthesizer

    return Synthesizer(model, TextTokenizer(backend="char"),
                       TextTokenCollater(
                           sorted(set("abcdefghijklmnopqrstuvwxyz_"))),
                       audio_tok, top_k=1, max_gen_len=max_gen_len,
                       compute_dtype=dtype, decode_mode=decode_mode,
                       codec_dtype="bfloat16", wav_transfer="pcm16", seed=1,
                       device="cuda", **kw)


def first_code_diff(model32, rec, got, ref):
    """Where one request's codes first differ between two greedy runs and,
    at a quantizer-0 frame, the top-2 margin of its AR logits there (a
    teacher-forced fp32 forward over the prompt and ``got``'s frames)."""
    import numpy as np
    import torch

    from valle_tpu_torch.models.inference import _frontends
    from valle_tpu_torch.modules.transformer import encoder_stack_apply
    from valle_tpu_torch.ops import masks as M

    n = min(got.shape[0], ref.shape[0])
    diff = np.argwhere(got[:n] != ref[:n])
    if diff.size == 0:
        return f"frames {got.shape[0]} vs {ref.shape[0]}, codes equal"
    f, q = (int(v) for v in diff[0])
    if q != 0:
        return f"first difference at frame {f}, NAR quantizer {q}"
    text = torch.as_tensor(rec["text"], device="cuda").long()
    seq = torch.as_tensor(np.concatenate(
        [rec["prompts"][0, : rec["p_len"], 0], got[:f, 0]])[None],
        device="cuda").long()
    with torch.no_grad():
        x, y = _frontends(model32, text, seq, torch.float32)
        bias = M.ar_xy_attn_bias(
            torch.tensor([rec["text_len"]], device="cuda"),
            torch.tensor([seq.shape[1]], device="cuda"), text.shape[1],
            seq.shape[1])
        hid = encoder_stack_apply(model32.ar_decoder, torch.cat([x, y], 1),
                                  bias)
        top = torch.topk(hid[0, -1] @ model32.ar_predict_layer.weight.T,
                         2).values
    return (f"first difference at frame {f}, AR: top-2 logit margin "
            f"{(top[0] - top[1]).item():.3e} (top {top[0].item():.3e})")


def check_cb_results(results, n, cap=None, allow_empty=False):
    """check_results, and every request's frames within its budget; with
    ``allow_empty`` a request may also end by EOS at frame 0."""
    if len(results) != n:
        raise RuntimeError(f"expected {n} results, got {len(results)}")
    kept = [r for r in results if r.frames or not allow_empty]
    check_results(kept, len(kept))
    if cap is not None and max(r.frames for r in results) > cap:
        raise RuntimeError(f"a request ran past its budget of {cap}")


def eos_token(results):
    """The token that the most of ``results`` first emit (quantizer 0)
    between an eighth and a half of their frames, and none at frame 0
    (ties: the earliest on average). An AR head whose EOS row is a little
    over that token's row ends each lane by EOS where it would first emit
    the token, so the lanes' ends spread."""
    first = [{} for _ in results]
    for r, d in zip(results, first):
        for f, tok in enumerate(r.codes[:, 0].tolist()):
            d.setdefault(tok, f)
    cand = {k for d in first for k in d if all(e.get(k, 1) > 0
                                                for e in first)}
    return max(cand, key=lambda k: (
        sum(r.frames // 8 <= d.get(k, r.frames) < r.frames // 2
            for r, d in zip(results, first)),
        -sum(d.get(k, 0) for d in first), -k))


@contextlib.contextmanager
def eos_at(model, tok, scale):
    """For the block, the AR head's EOS row is ``scale`` x token ``tok``'s
    row (lanes end by EOS where greedy decoding would first emit ``tok``);
    restored after."""
    import torch

    w = model.ar_predict_layer.weight
    eos = model.cfg.eos_id
    keep = w[eos].clone()
    with torch.no_grad():
        w[eos] = scale * w[tok]
    try:
        yield
    finally:
        with torch.no_grad():
            w[eos] = keep


def check_cb_fp32(model32, audio_tok, info):
    """6a, fp32 at full width, greedy unless said, budget CB_FP32_GEN:
    (i) 8 requests admitted in one wave (text 64, prompts 256) give
    ``valle_ar_decode``'s codes and lengths at B 8 on the same padding,
    greedy and at top_k 10 from one CUDA generator seed, and the sync-free
    categorical draw gives torch.multinomial's indices on the card; (ii)
    12 requests through 4 slots in chunks of 16 (texts of 1-12 characters,
    so their 16x caps differ), "lpt" and "fifo": each request's codes and
    frames equal the Synthesizer's ("exact", one batch on its own
    padding); (iii) the same with lanes that end by EOS mid-chunk (the
    AR head's EOS row 1.01 x the row of ``eos_token``'s pick from (ii)'s
    codes), "fifo": codes and frames equal the Synthesizer's again, and
    some request ends before its (ii) length. On a difference the first
    differing frame and its top-2 logit margin are logged before the
    phase fails."""
    import numpy as np
    import torch

    from valle_tpu_torch.models import cb_decode as cbd
    from valle_tpu_torch.models.inference import valle_ar_decode
    from valle_tpu_torch.ops.sampling import categorical
    from valle_tpu_torch.serving import SynthesisRequest

    res = {}
    gen = torch.Generator("cuda").manual_seed(21)
    lg = torch.randn(8, 1025, generator=gen, device="cuda") * 3
    same = all(torch.equal(
        categorical(lg, torch.Generator("cuda").manual_seed(s)),
        torch.multinomial(torch.softmax(lg, dim=-1), 1,
                          generator=torch.Generator("cuda").manual_seed(s))
        [:, 0]) for s in range(5))
    log(f"  sync-free categorical vs torch.multinomial, 5 seeds (B 8): "
        f"{'equal' if same else 'DIFFER'}")
    res["categorical_equals_multinomial"] = same
    if not same:
        raise RuntimeError("the categorical draw differs from "
                           "torch.multinomial's on the card")

    B, S, P, G = 8, CB["text_pad"], CB["prompt_pad"], CB_FP32_GEN
    text = torch.randint(3, 30, (B, S), generator=gen, device="cuda")
    tl = torch.tensor([64, 2, 17, 40, 3, 64, 9, 30], device="cuda")
    pq = torch.randint(0, 1024, (B, P), generator=gen, device="cuda")
    pl = torch.tensor([225, 256, 100, 225, 31, 200, 225, 150],
                      device="cuda")
    cache_len = S + int(model32.cfg.prepend_bos) + P + G + 1
    for top_k in (1, 10):
        ref = valle_ar_decode(model32, text, tl, pq, pl, top_k=top_k,
                              max_gen_len=G, generator=torch.Generator(
                                  "cuda").manual_seed(5))
        st = cbd.cb_state_init(model32.cfg, slots=B, cache_len=cache_len,
                               max_gen_len=G, device="cuda")
        k, v, lg0 = cbd.cb_prefill(model32, text, tl, pq, pl,
                                   cache_len=cache_len)
        cbd.cb_install_many(st, torch.arange(B), k, v, lg0, tl,
                            pl + int(model32.cfg.prepend_bos))
        g5 = torch.Generator("cuda").manual_seed(5)
        while not bool(st["done"].all()):
            cbd.cb_decode_chunk(model32, st, 1.0, S=S, K=CB["chunk"],
                                top_k=top_k, generator=g5)
        ok = (torch.equal(st["gen_codes"], ref[0])
              and torch.equal(st["gen_lens"], ref[1]))
        log(f"  fp32 CB, 8 requests in one wave vs valle_ar_decode (B 8, "
            f"top_k {top_k}): codes and lengths "
            f"{'equal' if ok else 'DIFFER'}; lengths "
            f"{st['gen_lens'].tolist()}")
        res[f"one_wave_top_k{top_k}"] = ok
        if not ok:
            raise RuntimeError(f"CB in one wave, top_k {top_k}: codes "
                               "differ from valle_ar_decode's")

    rng = np.random.RandomState(4)
    lens = [1, 7, 1, 3, 12, 1, 5, 9, 1, 2, 10, 1]
    reqs = [SynthesisRequest(text=s, prompt_codes=rng.randint(
        0, 1024, (rng.randint(30, P + 1), 8)))
        for s in (cb_texts(1, seed=40 + i, lo=n, hi=n)[0]
                  for i, n in enumerate(lens))]
    t0 = time.perf_counter()
    ref = static_engine(model32, audio_tok, torch.float32, "exact",
                        G).synthesize(reqs, max_gen_len=G)
    res["synthesizer_s"] = time.perf_counter() - t0
    check_cb_results(ref, len(reqs), G)
    for admission in ("lpt", "fifo"):
        cb = cb_engine(model32, audio_tok, torch.float32, slots=4,
                       max_gen_len=G, chunk=16, admission=admission)
        t0 = time.perf_counter()
        got = cb.run(reqs)
        wall = time.perf_counter() - t0
        check_cb_results(got, len(reqs), G)
        bad = [i for i, (a, b) in enumerate(zip(got, ref))
               if a.frames != b.frames or not np.array_equal(a.codes,
                                                             b.codes)]
        log(f"  fp32 CB, 12 requests through 4 slots ({admission}): "
            f"{wall:.3f} s, {cb.last_stats}, frames "
            f"{[r.frames for r in got]}; codes vs the Synthesizer's "
            f"(exact): {'equal' if not bad else f'DIFFER in {bad}'}")
        res[f"recycled_{admission}"] = {"equal": not bad, "wall_s": wall,
                                        "stats": cb.last_stats,
                                        "frames": [r.frames for r in got]}
        if bad:
            for i in bad:
                log(f"    request {i}: " + first_code_diff(
                    model32, cb._prep_one(reqs[i]), got[i].codes,
                    ref[i].codes))
            raise RuntimeError(f"CB ({admission}): codes differ from the "
                               f"Synthesizer's for requests {bad}")
        if cb.last_stats["waves"] < 3:
            raise RuntimeError("12 requests through 4 slots took fewer "
                               "than 3 waves")

    tok = eos_token(ref)
    with eos_at(model32, tok, 1.01):
        want = static_engine(model32, audio_tok, torch.float32, "exact",
                             G).synthesize(reqs, max_gen_len=G)
        cb = cb_engine(model32, audio_tok, torch.float32, slots=4,
                       max_gen_len=G, chunk=16, admission="fifo")
        got = cb.run(reqs)
    check_cb_results(want, len(reqs), G, allow_empty=True)
    check_cb_results(got, len(reqs), G, allow_empty=True)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a.frames != b.frames or not np.array_equal(a.codes, b.codes)]
    early = [i for i in range(len(reqs)) if want[i].frames < ref[i].frames]
    log(f"  fp32 CB, the 12 ending by EOS at token {tok} (fifo): "
        f"{cb.last_stats}, frames {[r.frames for r in got]} ({len(early)} "
        f"ended early); codes vs the Synthesizer's (exact): "
        f"{'equal' if not bad else f'DIFFER in {bad}'}")
    res["eos_endings"] = {"token": tok, "equal": not bad,
                          "stats": cb.last_stats, "early": early,
                          "frames": [r.frames for r in got]}
    if bad:
        raise RuntimeError(f"CB with EOS endings: codes differ from the "
                           f"Synthesizer's for requests {bad}")
    if not early:
        raise RuntimeError(f"no request ended by EOS at token {tok}")
    info["cb_fp32"] = res


def run_cb_full_width(model, audio_tok, info):
    """6b, bf16 at full width: 24 requests with 225-frame prompts and
    seeded texts of 2-30 characters (16x caps of 64-512 frames), greedy,
    in turns: ContinuousBatcher (CB's shape, NAR "auto" -> B4 forward),
    the Synthesizer in "exact" (the CB step's math) and in "fused" over
    plan_groups' groups of 8. Each CB run
    launches the B4 forward exactly groups x 7 x NAR layers times. Then,
    with lanes that end by EOS (the AR head's EOS row 1.05 x the row of
    ``eos_token``'s pick from the last CB run's codes), the
    ContinuousBatcher and the Synthesizer "exact" once each (B4 counted
    as before; steps run against those planned logged). Then a CB run of
    the 12 shortest requests with the flash switch on (NAR
    einsum, fp32 scores): B6 exactly waves x layers (prefill) + groups x
    7 x NAR layers, and no B4. Logged: wall s, AR frames/s, chunks,
    waves, steps, install_s, decode_s; the profiler's busy share of a CB
    run of the 6 shortest requests (one wave: a trace of every kernel of
    a longer run takes longer to parse than the run). Returns the
    launches counted."""
    import math

    import numpy as np
    import torch

    from valle_tpu_torch.ops import cuda_build as cbk
    from valle_tpu_torch.serving import SynthesisRequest, plan_groups

    rng = np.random.RandomState(6)
    reqs = [SynthesisRequest(text=s, prompt_codes=rng.randint(
        0, 1024, (225, 8))) for s in cb_texts(CB_REQUESTS, seed=6)]
    L, Ln = model.cfg.num_layers, model.cfg.nar_num_layers
    groups = math.ceil(CB_REQUESTS / CB["slots"])
    cb = cb_engine(model, audio_tok, torch.bfloat16)
    static = {m: static_engine(model, audio_tok, torch.bfloat16, m,
                               CB["max_gen_len"]) for m in ("exact", "fused")}

    def timed(label, fn, n=CB_REQUESTS, allow_empty=False):
        torch.cuda.synchronize()
        cbk.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in cbk.LAUNCHES.items() if v}
        check_cb_results(out, n, CB["max_gen_len"], allow_empty)
        frames = sum(r.frames for r in out)
        run = {"wall_s": wall, "frames": frames,
               "frames_per_s": frames / wall, "launches": counts}
        log(f"  {label}: {wall:.3f} s, {frames} frames, "
            f"{frames / wall:.1f} AR frames/s, launches {counts}")
        return out, run

    def static_run(mode):
        out = [None] * len(reqs)
        for g in plan_groups(reqs, CB["slots"]):
            for i, r in zip(g, static[mode].synthesize([reqs[i]
                                                        for i in g])):
                out[i] = r
        return out

    engines = {"continuous": lambda: cb.run(reqs),
               "static exact": lambda: static_run("exact"),
               "static fused": lambda: static_run("fused")}
    def cb_stats(run):
        s = cb.last_stats
        run.update(s, ar_frames_per_s=run["frames"] / (
            s["install_s"] + s["decode_s"]))
        log(f"    chunks {s['chunks']}, waves {s['waves']}, steps "
            f"{s['steps']} of {s['steps_planned']} planned, install_s "
            f"{s['install_s']:.3f}, decode_s {s['decode_s']:.3f}, AR "
            f"frames/s (install + decode) {run['ar_frames_per_s']:.1f}")
        want = groups * 7 * Ln
        got = run["launches"].get("flash_mha_fwd", 0)
        if got != want:
            raise RuntimeError(f"CB run: {got} flash_mha_fwd launches, "
                               f"expected {want} ({groups} groups x 7 x "
                               f"{Ln})")

    runs = {}
    for label in ("continuous", "static exact", "static fused"):
        out, run = timed(label, engines[label])
        if label.startswith("continuous"):
            cb_stats(run)
        runs[label] = run
    log(f"  frames per request (CB): {[r.frames for r in out]}")

    tok = eos_token(out)
    with eos_at(model, tok, 1.05):
        for label in ("continuous", "static exact"):
            got, run = timed(f"{label}, ending by EOS at token {tok}",
                             engines[label], allow_empty=True)
            if label == "continuous":
                cb_stats(run)
            run["early"] = sum(a.frames < b.frames
                               for a, b in zip(got, out))
            log(f"    frames per request {[r.frames for r in got]}, "
                f"{run['early']} ended early")
            runs[f"{label}, EOS endings"] = run

    short = sorted(reqs, key=lambda r: len(r.text))
    switch = cb_engine(model, audio_tok, torch.bfloat16,
                       nar_attn_impl="einsum", nar_score_bf16="off")
    flash_switch(True)
    try:
        _, run = timed("continuous, the 12 shortest, flash switch on (NAR "
                       "einsum)", lambda: switch.run(short[:12]), 12)
    finally:
        flash_switch(False)
    waves, groups = switch.last_stats["waves"], math.ceil(12 / CB["slots"])
    want = waves * L + groups * 7 * Ln
    got = run["launches"].get("flash_attention", 0)
    run.update(switch.last_stats)
    if got != want or run["launches"].get("flash_mha_fwd", 0):
        raise RuntimeError(f"CB with the switch: {got} flash_attention "
                           f"launches, expected {want} ({waves} waves x {L}"
                           f" + {groups} x 7 x {Ln}), and no flash_mha_fwd")
    runs["continuous, 12 shortest, switch on"] = run

    prof = profile_busy(lambda: (cb.run(short[:6]),
                                 torch.cuda.synchronize()), "trace_cb.json",
                        warm=False)        # cb has run these shapes
    log_busy("CB run, the 6 shortest requests", prof)
    info["cb_full_width"] = {"runs": runs, "profile_6_shortest": prof,
                             "texts": [r.text for r in reqs]}
    return {"flash_mha_fwd": sum(runs[k]["launches"].get("flash_mha_fwd", 0)
                                 for k in ("continuous",
                                           "continuous, EOS endings")),
            "flash_attention": got}


def start_server(d, flags, name):
    """``python -m valle_tpu_torch.bin.serve`` in a session of its own,
    its log in ``d``; returns (process, log path)."""
    import os

    root = Path(__file__).resolve().parent
    logf = d / f"{name}.log"
    cmd = [sys.executable, "-m", "valle_tpu_torch.bin.serve",
           "--checkpoint", str(d / "m.pt"), "--encodec-weights",
           str(d / "codec.th")] + SERVE_FLAGS + flags
    with open(logf, "w") as fh:
        proc = subprocess.Popen(cmd, cwd=str(root), stdout=fh,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=str(root)),
                                start_new_session=True)
    return proc, logf


def server_port(proc, logf, timeout=300):
    import re

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        m = re.search(r"serving on [\d.]+:(\d+)", logf.read_text())
        if m:
            return int(m.group(1)), time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.5)
    raise RuntimeError(f"the server did not start:\n"
                       f"{logf.read_text()[-4000:]}")


def stop_server(proc):
    import os
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode


def http_post(port, body, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return (r.status, r.headers.get("Content-Type"), r.read(),
                time.perf_counter() - t0)


def check_wav_answer(ans):
    """A 200 audio/wav answer: 24 kHz mono PCM16, frames x 320 samples."""
    import io
    import wave

    status, ctype, blob, _ = ans
    if status != 200 or ctype != "audio/wav":
        raise RuntimeError(f"answer {status} {ctype}")
    with wave.open(io.BytesIO(blob)) as w:
        n = w.getnframes()
        if (w.getframerate(), w.getnchannels(), w.getsampwidth()) != (
                24000, 1, 2) or n <= 0 or n % 320:
            raise RuntimeError(f"bad wav answer: {n} samples at "
                               f"{w.getframerate()} Hz")
    return n // 320


def serve_over_http(d, info):
    """6c: the server CLI on the card, both modes started together (each
    loads phase 3b's .pt and codec): ``--mode continuous --slots 8`` gets
    GET /healthz and 16 concurrent POST /synthesize, 8 with prompt codes
    and 8 with phase 3b's prompt wavs; each answers 200 with a 24 kHz
    mono wav of frames x 320 samples, and one ``codes_only`` answer gives
    (frames, 8) codes in 0-1023 within its 16x cap. Sent with them, a
    text longer than ``--text-pad`` holds answers 413 and a prompt wav
    that cannot be read 400, each alone. Then one request to
    ``--mode static --decode-mode fused``. Both stopped by SIGINT, and
    must exit 0; seconds per request logged."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    servers = {"continuous": start_server(
                   d, ["--mode", "continuous", "--slots",
                       str(CB["slots"])], "serve_continuous"),
               "static": start_server(
                   d, ["--mode", "static", "--decode-mode", "fused"],
                   "serve_static")}
    res = {}
    try:
        ports = {}
        for name, (proc, logf) in servers.items():
            ports[name], secs = server_port(proc, logf)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports[name]}/healthz") as r:
                health = json.loads(r.read())
            log(f"  {name} server up in {secs:.1f} s, healthz {health}")
            if health.get("status") != "ok" or health.get("mode") != name:
                raise RuntimeError(f"{name} healthz: {health}")
        rng = np.random.RandomState(8)
        bodies = [{"text": t, "prompt_codes": rng.randint(
            0, 1024, (225, 8)).tolist()} for t in TEXTS]
        bodies += [{"text": t, "prompt_wav": str(d / f"p{i + 1}.wav")}
                   for i, t in enumerate(TEXTS)]
        bodies[3]["codes_only"] = True
        refused = {len(bodies): 413, len(bodies) + 1: 400}
        bodies += [{"text": "x" * (CB["text_pad"] + 10)},
                   {"text": "hi", "prompt_wav": str(d / "missing.wav")}]
        answers = [None] * len(bodies)

        def post(i):
            try:
                answers[i] = http_post(ports["continuous"], bodies[i])
            except urllib.error.HTTPError as e:
                answers[i] = (e.code, None, e.read(), None)
            except Exception as e:        # noqa: BLE001 - checked below
                answers[i] = e

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        frames = []
        for i, code in refused.items():
            if isinstance(answers[i], Exception) or answers[i][0] != code:
                raise RuntimeError(f"request {i}: {answers[i]!r}, expected "
                                   f"{code}")
        log(f"  refused alone: {[answers[i][:3] for i in refused]}")
        answers = answers[:-len(refused)]
        for i, ans in enumerate(answers):
            if isinstance(ans, Exception):
                raise RuntimeError(f"request {i}: {ans!r}")
            if i == 3:
                body = json.loads(ans[2])
                codes = np.asarray(body["codes"])
                cap = min(CB["max_gen_len"], 16 * (len(TEXTS[3]) + 2) + 1)
                if (ans[0] != 200 or codes.shape != (body["frames"], 8)
                        or not 0 < body["frames"] <= cap
                        or codes.min() < 0 or codes.max() > 1023):
                    raise RuntimeError(f"codes_only answer {ans[0]}: "
                                       f"{codes.shape}, frames "
                                       f"{body['frames']} (cap {cap})")
                frames.append(body["frames"])
            else:
                frames.append(check_wav_answer(ans))
        lat = [a[3] for a in answers]
        log(f"  continuous server, {len(answers)} concurrent requests (8 "
            f"prompt codes, 8 prompt wavs): {wall:.3f} s, "
            f"{wall / len(answers):.3f} s a request, latency "
            f"{min(lat):.3f}-{max(lat):.3f} s, frames {frames}")
        res["continuous"] = {"wall_s": wall, "latency_s": lat,
                             "frames": frames}
        ans = http_post(ports["static"], bodies[11])   # cap 209 frames
        n = check_wav_answer(ans)
        log(f"  static server (fused), one prompt-wav request: "
            f"{ans[3]:.3f} s, {n} frames")
        res["static"] = {"latency_s": ans[3], "frames": n}
    finally:
        codes = {name: stop_server(proc)
                 for name, (proc, _) in servers.items()}
        log(f"  servers stopped, exit codes {codes}")
    if any(codes.values()):
        raise RuntimeError(f"a server did not exit cleanly: {codes}")
    info["serve_http"] = res


def run_continuous_batching(d, info):
    """Phase 6 on phase 3b's checkpoint and codec in ``d``: 6a on the fp32
    model, 6b on it cast to bf16, 6c through the server CLI. Returns 6b's
    launches."""
    import torch

    from valle_tpu_torch.data.tokenizer import AudioTokenizer
    from valle_tpu_torch.models import load_model

    t0 = time.perf_counter()
    model32, _ = load_model(str(d / "m.pt"), device="cuda")
    audio_tok = AudioTokenizer(weights_path=str(d / "codec.th"),
                               device="cuda")
    log_phase(" 6a: fp32 continuous batching against the batch decode")
    check_cb_fp32(model32, audio_tok, info)
    log_phase(" 6b: bf16 continuous batching at full width")
    launches = run_cb_full_width(model32.to(torch.bfloat16), audio_tok,
                                 info)
    del model32, audio_tok
    torch.cuda.empty_cache()
    log_phase(" 6c: the HTTP server on the card")
    serve_over_http(d, info)
    info["phase6_s"] = time.perf_counter() - t0
    return launches


# ---------------------------------------------------------------------------
# phase 7: VALL-F, prenets, post-norm
# ---------------------------------------------------------------------------

VARIANT_FP32 = dict(FULL, num_layers=2)     # 7a: d 1024, 16 heads, 2 layers
POSTNORM = dict(norm_first=False, add_prenet=True)
VALLF = dict(model_name="vallf")
# 7b's post-norm runs: Synthesizer modes and the kernels each launches
POSTNORM_MODES = {"exact": (), "int8": ("decode_attention_int8_grouped",),
                  "bf16": ("decode_attention_kv",),
                  "lanes": ("decode_attention_lanes",)}
VARIANT_STEPS = 3       # 7c's train steps a stage


def seeded_statistics(model, seed):
    """The prenets' running statistics drawn from ``seed``: a trained
    model's are not the fresh zeros and ones."""
    import torch

    from valle_tpu_torch.modules.prenet import batch_norms

    gen = torch.Generator(next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for bn in batch_norms(model):
            bn.running_mean.normal_(0.0, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


def statistics(model):
    """Every prenet BatchNorm buffer of ``model``, cloned, by name."""
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if "_text_prenet." in n}


def b6_launches(q_len, k_len, layers):
    """B6 launches of ``layers`` attentions of ``q_len`` queries over
    ``k_len`` keys under the switch at Dh 64 (``ops/attention.py
    use_flash_kernel``: S > 1 and T >= MIN_KERNEL_T)."""
    from valle_tpu_torch.ops.attention import MIN_KERNEL_T

    return layers if q_len > 1 and k_len >= MIN_KERNEL_T else 0


def vallf_b6_count(cfg, S, P, G):
    """B6 launches of one VALL-F synthesis batch under the switch, from
    the code's shapes: the prefill's self-attention over the prompt and
    its cross-attention over the text (S keys); each of the Q - 1 NAR
    passes the same over P + G frames; the decode steps' one query never
    takes B6."""
    bos = int(cfg.prepend_bos)
    ar = (b6_launches(bos + P, bos + P, cfg.num_layers)
          + b6_launches(bos + P, S, cfg.num_layers))
    nar = (b6_launches(P + G, P + G, cfg.nar_num_layers)
           + b6_launches(P + G, S, cfg.nar_num_layers))
    return ar + (cfg.num_quantizers - 1) * nar


def check_vallf_fp32(info):
    """7a, VALL-F at fp32: greedy codes on the card equal the port's on
    the CPU (4 requests, 225-frame prompts, 24 frames); with the switch on
    against off, the prefill's hidden states and a NAR pass's logits
    within 1e-5 of the largest entry, B6 launched as counted."""
    import torch

    from valle_tpu_torch.models.inference import _frontends, valle_inference
    from valle_tpu_torch.models.valle import (VALLE, ValleConfig,
                                              nar_predict_weights)
    from valle_tpu_torch.modules.transformer import (decoder_stack_apply,
                                                     decoder_stack_prefill)
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops import masks as M

    gen = torch.Generator("cuda").manual_seed(71)
    model = VALLE(ValleConfig(**dict(VARIANT_FP32, **VALLF)),
                  generator=gen).eval()
    cfg = model.cfg
    B, S, P = 4, 32, 225
    text = torch.randint(3, 30, (B, S), generator=gen, device="cuda")
    tl = torch.tensor([32, 20, 9, 27], device="cuda")
    pc = torch.randint(0, 1024, (B, P, 8), generator=gen, device="cuda")
    pl = torch.tensor([225, 200, 225, 180], device="cuda")
    card = valle_inference(model, text, tl, pc, pl, top_k=1, max_gen_len=24)
    cpu = copy.deepcopy(model).cpu()
    ref = valle_inference(cpu, *(a.cpu() for a in (text, tl, pc, pl)),
                          top_k=1, max_gen_len=24)
    del cpu
    share = (card[0].cpu() == ref[0]).float().mean().item()
    same_len = torch.equal(card[1].cpu(), ref[1])
    log(f"  VALL-F fp32 greedy codes, card vs CPU (B 4, prompts 225, 24 "
        f"frames): {share:.4f} equal, lengths "
        f"{'equal' if same_len else 'DIFFER'} {card[1].tolist()}")
    if share != 1.0 or not same_len:
        raise RuntimeError(f"VALL-F card codes differ from the CPU's "
                           f"({share:.4f} equal)")
    res = {"codes_equal_share": share}

    x, y = _frontends(model, text, pc[..., 0], torch.float32)
    cross = M.key_padding_bias(tl, S)
    self_bias = M.causal_bias(P, "cuda") + M.key_padding_bias(pl, P)
    G = PREFILL["G"]
    seq = torch.randn(B, P + G, cfg.nar_d_model, generator=gen,
                      device="cuda")
    nbias = M.key_padding_bias(pl + G, P + G)
    cond = model.nar_stage_embeddings[0].word_embeddings.weight
    W = nar_predict_weights(model)[0]

    def prefill():
        return decoder_stack_prefill(
            model.ar_decoder, y, x, self_bias, cross, cache_len=P + 1,
            activation=cfg.activation, dtype=torch.float32)[0]

    def nar_logits():
        hid = decoder_stack_apply(model.nar_decoder, seq, x, nbias, cross,
                                  cond, activation=cfg.activation,
                                  dtype=torch.float32)
        return hid[:, -G:] @ W.T

    for name, fn, want in (
            ("prefill hidden", prefill,
             b6_launches(P, P, cfg.num_layers)
             + b6_launches(P, S, cfg.num_layers)),
            ("NAR pass logits", nar_logits,
             b6_launches(P + G, P + G, cfg.nar_num_layers)
             + b6_launches(P + G, S, cfg.nar_num_layers))):
        flash_switch(True)
        cb.reset_launch_counts()
        on = fn()
        n = cb.LAUNCHES["flash_attention"]
        flash_switch(False)
        off = fn()
        rel = ((on - off).abs().max() / off.abs().max()).item()
        log(f"  VALL-F fp32 {name}, switch on vs off: rel {rel:.3e} (limit "
            f"1e-5), flash_attention launches {n} (want {want})")
        if rel > 1e-5 or n != want or want == 0:
            raise RuntimeError(f"VALL-F flash switch: {name} rel {rel:.3e}, "
                               f"launches {n} (want {want})")
        res[name] = rel
    info["vallf_fp32"] = res
    del model
    torch.cuda.empty_cache()


def check_postnorm_fp32(info):
    """7a, a post-norm prenet VALL-E at fp32 (statistics from a seed):
    every kernel mode that takes post-norm layers against "exact"
    (``check_reference``: bf16, lanes; grouped and per_sample; int8
    against the plain int8 path on the CPU), and every fused mode
    refused with the error that names it."""
    import torch

    from valle_tpu_torch.models.inference import valle_inference
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    model = seeded_statistics(VALLE(
        ValleConfig(**dict(VARIANT_FP32, **POSTNORM)),
        generator=torch.Generator("cuda").manual_seed(72)).eval(), 73)
    check_reference(model, info, " (post-norm, prenets)",
                    modes=("bf16", "lanes"), int8_modes=("int8",))
    x = torch.zeros(8, 16, dtype=torch.long, device="cuda") + 3
    lens = torch.full((8,), 16, device="cuda")
    pc = torch.zeros(8, 8, 8, dtype=torch.long, device="cuda")
    refused = []
    for mode in ("fused", "fused_w8", "fused_int8", "fused_kv",
                 "fused_lanes", "mega"):
        try:
            valle_inference(model, x, lens, pc, lens // 2, top_k=1,
                            max_gen_len=4, decode_mode=mode)
        except ValueError as e:
            if mode not in str(e) or "post-norm" not in str(e):
                raise
            refused.append(mode)
        else:
            raise RuntimeError(f"decode mode {mode} ran post-norm layers")
    log(f"  post-norm fused modes refused, naming the mode: {refused}")
    info["postnorm_refused"] = refused
    del model
    torch.cuda.empty_cache()


def timed_synthesis(synth, reqs, name, card):
    """One Synthesizer batch with counts set to 0 before it and read after:
    (results, launches, seconds)."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb

    torch.cuda.synchronize()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res = synth.synthesize(reqs, max_gen_len=150)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cb.LAUNCHES)
    check_results(res, len(reqs))
    frames = sum(r.frames for r in res)
    log(f"  {name}: ran {synth.last_decode_mode!r}, {len(reqs)} requests, "
        f"{dt:.3f} s, {frames} frames, {frames / dt:.1f} frames/s, "
        f"launches { {k: v for k, v in counts.items() if v} }; {card}")
    return res, counts, dt


def run_variants_bf16(audio_tok, reqs, card, info):
    """7b at full width, bf16, seeded weights: VALL-F through the
    Synthesizer with the switch on (NAR einsum, fp32 scores), B6 launched
    as ``vallf_b6_count`` says; a post-norm prenet VALL-E in exact, int8,
    bf16 and lanes (each mode's kernel, and B4's forward in the NAR
    passes, launched) and through valle_ar_decode's grouped (B 8) and
    per_sample (B 6) runs, 150 frames each. Returns the launches."""
    import torch

    from valle_tpu_torch.models.inference import valle_ar_decode
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.ops import cuda_build as cb

    res, launches = {}, {}
    model = VALLE(ValleConfig(**dict(FULL, **VALLF)),
                  generator=torch.Generator("cuda").manual_seed(74)).eval()
    model = model.to(torch.bfloat16)
    synth = build_synth(model, audio_tok, "fused", nar_score_bf16="off")
    text_ids, _, prompts, _, _ = synth._prepare(reqs)
    want = vallf_b6_count(model.cfg, text_ids.shape[1], prompts.shape[1],
                          150)
    flash_switch(True)
    try:
        _, counts, dt = timed_synthesis(synth, reqs, "VALL-F, switch on",
                                        card)
    finally:
        flash_switch(False)
    n = counts["flash_attention"]
    log(f"  VALL-F: flash_attention launches {n}, counted {want} (text "
        f"{text_ids.shape[1]}, prompts {prompts.shape[1]}, 150 frames)")
    if n != want or synth.last_decode_mode != "exact":
        raise RuntimeError(f"VALL-F switch-on batch: {n} flash_attention "
                           f"launches, counted {want}; ran "
                           f"{synth.last_decode_mode!r}")
    res["vallf"] = {"s": dt, "b6": n, "b6_counted": want}
    launches["vallf"] = counts
    del model, synth
    torch.cuda.empty_cache()

    model = seeded_statistics(VALLE(
        ValleConfig(**dict(FULL, **POSTNORM)),
        generator=torch.Generator("cuda").manual_seed(75)).eval(), 76)
    model = model.to(torch.bfloat16)
    for mode, kernels in POSTNORM_MODES.items():
        synth = build_synth(model, audio_tok, mode)
        _, counts, dt = timed_synthesis(synth, reqs,
                                        f"post-norm prenets, {mode}", card)
        nar_b4 = 7 * model.cfg.nar_num_layers
        if synth.last_decode_mode != mode or any(
                counts[k] <= 0 for k in kernels) or (
                counts["flash_mha_fwd"] != nar_b4):
            raise RuntimeError(f"post-norm {mode}: ran "
                               f"{synth.last_decode_mode!r}, launches "
                               f"{counts} (want {kernels} and "
                               f"{nar_b4} flash_mha_fwd)")
        res[f"postnorm_{mode}"] = {"s": dt}
        launches[f"postnorm_{mode}"] = counts
    gen = torch.Generator("cuda").manual_seed(77)
    for mode, B, kernel in TRANSPOSED_RUNS:
        B = 8 if mode == "grouped" else B
        text = torch.randint(3, 30, (B, 64), generator=gen, device="cuda")
        pq = torch.randint(0, 1024, (B, 225), generator=gen, device="cuda")
        lens = torch.full((B,), 64, device="cuda")
        plens = torch.full((B,), 225, device="cuda")
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        valle_ar_decode(model, text, lens, pq, plens, top_k=10,
                        max_gen_len=150, compute_dtype=torch.bfloat16,
                        force_full_length=True, decode_mode=mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n, want_n = cb.LAUNCHES[kernel], 150 * model.cfg.num_layers
        log(f"  post-norm prenets, valle_ar_decode {mode} B {B}, 150 "
            f"frames: {dt:.3f} s, {B * 150 / dt:.1f} frames/s, {kernel} "
            f"launches {n} (want {want_n}); {card}")
        if n != want_n:
            raise RuntimeError(f"post-norm {mode}: {n} {kernel} launches, "
                               f"want {want_n}")
        res[f"postnorm_{mode}"] = {"s": dt, "B": B}
        launches[f"postnorm_{mode}"] = dict(cb.LAUNCHES)
    info["variants_bf16"] = res
    del model
    torch.cuda.empty_cache()
    return launches


def train_variant(model, stage, impl, batches, host_gen):
    """VARIANT_STEPS bf16 steps of ``stage`` through ``impl``: (losses,
    launches)."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    with_impl(model, impl, stage)
    opt, lr_fn = make_optimizer(model, train_stage=stage)
    step = make_train_step(lr_fn, train_stage=stage,
                           compute_dtype=torch.bfloat16)
    state = TrainState(model, opt)
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    outs = [step(state, b, 0, host_gen) for b in batches]
    torch.cuda.synchronize()
    losses = [o["loss"].item() / o["frames"].item() for o in outs]
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise RuntimeError(f"stage {stage} {impl}: non-finite losses "
                           f"{losses}")
    return losses, dict(cb.LAUNCHES)


def train_variants(cli_dir, card, info):
    """7c at full width, bf16, dropout 0.1: VARIANT_STEPS steps of VALL-F
    (einsum) and of a post-norm prenet VALL-E (B4/B5, launches as counted)
    in stage 1 (remat full) and stage 2 (remat none), at the AR and NAR
    recipes' shapes; the prenets' statistics move in training and not in
    a validation pass. Then the trainer CLI: 2 VALL-F steps to a .pt file,
    and ``bin/infer.py`` on it with phase 3b's codec and prompt, plainly
    and with ``--continual true``. Returns
    the post-norm runs' launches."""
    import torch

    from valle_tpu_torch.bin import infer, trainer
    from valle_tpu_torch.models.valle import VALLE, ValleConfig, valle_forward

    gen = torch.Generator("cuda").manual_seed(78)
    host_gen = torch.Generator().manual_seed(79)
    batches = {s: [train_batch(r["B"], r["S"], r["T"], gen)
                   for _ in range(VARIANT_STEPS)]
               for s, r in ((1, AR_RECIPE), (2, NAR_RECIPE))}
    res, launches = {}, {}
    for name, extra, impl in (("vallf", VALLF, "einsum"),
                              ("postnorm", POSTNORM, "flash")):
        model = VALLE(ValleConfig(**dict(FULL, **extra)),
                      generator=torch.Generator("cuda").manual_seed(80))
        for stage in (1, 2):
            before = statistics(model)
            t0 = time.perf_counter()
            losses, counts = train_variant(model, stage, impl,
                                           batches[stage], host_gen)
            dt = time.perf_counter() - t0
            after = statistics(model)
            branch = "ar_" if stage == 1 else "nar_"
            moved = sorted({n.split(".")[0] for n in after
                            if not torch.equal(after[n], before[n])})
            L = model.cfg.num_layers
            bwd = L * VARIANT_STEPS if impl == "flash" else 0
            want = {"flash_mha_bwd": bwd, "flash_mha_fwd": bwd * (
                2 if model.cfg.remat == "full" else 1)}
            got = {k: counts[k] for k in want}
            log(f"  {name} stage {stage} ({impl}, remat {model.cfg.remat}), "
                f"{VARIANT_STEPS} bf16 steps: loss/frame "
                f"{[round(v, 4) for v in losses]}, {dt:.2f} s, launches "
                f"{got} (want {want}), statistics moved {moved}; {card}")
            if got != want:
                raise RuntimeError(f"{name} stage {stage}: launches {got}, "
                                   f"want {want}")
            if extra.get("add_prenet") and moved != [branch + "text_prenet"]:
                raise RuntimeError(f"{name} stage {stage}: statistics "
                                   f"moved in {moved}")
            res[f"{name}_stage{stage}"] = {"loss_per_frame": losses, "s": dt}
            launches[f"{name}_stage{stage}"] = got
        if extra.get("add_prenet"):
            before = statistics(model)
            with torch.no_grad():
                valle_forward(model, batches[2][0], train_stage=0,
                              deterministic=True,
                              compute_dtype=torch.bfloat16)
            same = all(torch.equal(v, statistics(model)[n])
                       for n, v in before.items())
            log(f"  {name}: a validation pass leaves the statistics "
                f"{'unchanged' if same else 'CHANGED'}")
            if not same:
                raise RuntimeError("a validation pass moved the statistics")
        del model
        torch.cuda.empty_cache()

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_vallf_"))
    atexit.register(shutil.rmtree, d, True)
    corpus, exp = d / "corpus", d / "exp"
    corpus.mkdir()
    write_train_corpus(corpus, prefix="vallf_")
    argv = ["--manifest-dir", str(corpus), "--text-tokens",
            str(corpus / "unique_text_tokens.k2symbols"), "--exp-dir",
            str(exp), "--model-name", "VALL-F", "--decoder-dim",
            str(FULL["d_model"]), "--nhead", str(FULL["nhead"]),
            "--num-decoder-layers", str(FULL["num_layers"]),
            "--prefix-mode", "1", "--train-stage", "1", "--num-epochs", "1",
            "--max-duration", "40", "--num-buckets", "2", "--dtype",
            "bfloat16", "--max-steps-per-epoch", "2", "--save-every-n",
            "1000", "--valid-interval", "1000", "--oom-check", "false",
            "--tensorboard", "false"]
    t0 = time.perf_counter()
    stats = trainer.run(trainer.get_parser().parse_args(argv))
    t1 = time.perf_counter()
    if stats.steps != 2 or stats.state.model.cfg.model_name != "vallf":
        raise RuntimeError(f"VALL-F trainer: {stats.steps} steps of "
                           f"{stats.state.model.cfg.model_name}")
    losses = [m[0] / m[1] for m in stats.step_metrics]
    del stats
    torch.cuda.empty_cache()
    cli = ["--checkpoint", str(exp / "epoch-1.pt"), "--encodec-weights",
           str(cli_dir / "codec.th"), "--text-extractor", "char",
           "--audio-prompts", str(cli_dir / "p0.wav"), "--text", TEXTS[0],
           "--top-k", "10", "--max-gen-len", str(CLI_GEN), "--device",
           "cuda"]
    infer.main(cli + ["--output-dir", str(d / "out")])
    t2 = time.perf_counter()
    # --continual: the NAR passes over the prompt's second half (113 of
    # the 3 s prompt's 225 frames), whatever the AR would do
    infer.main(cli + ["--output-dir", str(d / "cont"), "--continual",
                      "true"])
    t3 = time.perf_counter()
    wav = d / "out" / "0.wav"
    frames = check_wav(wav) if wav.exists() else 0
    cont = check_wav(d / "cont" / "0.wav", 113)
    log(f"  trainer CLI, VALL-F full width, 2 bf16 steps (stage 1): loss/"
        f"frame {[round(v, 4) for v in losses]}, {t1 - t0:.1f} s with "
        f"epoch-1.pt's write; bin/infer on it: {frames} frames"
        f"{' (the AR stopped at its first step)' if not frames else ''}, "
        f"{t2 - t1:.1f} s; --continual: {cont} frames, {t3 - t2:.1f} s; "
        f"{card}")
    res["trainer_vallf"] = {"s": t1 - t0, "infer_s": t2 - t1,
                            "frames": frames, "continual_frames": cont,
                            "continual_s": t3 - t2,
                            "loss_per_frame": losses}
    info["variants_training"] = res
    shutil.rmtree(d, ignore_errors=True)
    return launches


def run_variants(cli_dir, card, info):
    """Phase 7 (no profiler trace): 7a fp32 checks, 7b bf16 synthesis, 7c
    training. TF32 stays off throughout. Returns (7b's, 7c's) launches."""
    import numpy as np
    import torch

    from valle_tpu_torch.data.tokenizer import AudioTokenizer
    from valle_tpu_torch.serving import SynthesisRequest

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log_phase(" 7a: fp32, d 1024, 16 heads, 2 layers")
    check_vallf_fp32(info)
    check_postnorm_fp32(info)
    log_phase(" 7b: bf16 synthesis at full width")
    rng = np.random.RandomState(7)
    reqs = [SynthesisRequest(text=t,
                             prompt_codes=rng.randint(0, 1024, (225, 8)))
            for t in TEXTS]
    audio_tok = AudioTokenizer(device="cuda", seed=0)
    synth_launches = run_variants_bf16(audio_tok, reqs, card, info)
    del audio_tok
    torch.cuda.empty_cache()
    log_phase(" 7c: bf16 training at full width")
    train_launches = train_variants(cli_dir, card, info)
    info["phase7_s"] = time.perf_counter() - t0
    log(f"  phase 7 took {info['phase7_s']:.1f} s; {card}")
    return synth_launches, train_launches


TTS = dict(d_model=1024, nhead=16, num_mel_bins=100)
TTS_SMALL = dict(B=4, S=40, T=64, G=32)          # 8a, card vs CPU
TTS_SWITCH = dict(B=4, S=160, T=200, G=24)       # 8a, switch on vs off
TTS_FULL = dict(B=8, S=160, G=200, layers=12)    # 8b inference
# 8b's corpus: every dev cut 150 characters and 300 fbank frames (3.2 s),
# so each validation batch's attentions all have >= 128 keys
TTS_CORPUS = dict(train=24, dev=4, frames=(200, 401), dev_frames=300,
                  text=150)
TTS_FLAGS = ["--model-name", "transformer", "--decoder-dim", "1024",
             "--nhead", "16", "--num-decoder-layers", "12",
             "--dtype", "bfloat16", "--max-duration", "40",
             "--num-epochs", "1", "--max-steps-per-epoch", "3",
             "--valid-interval", "3", "--num-buckets", "2",
             "--tensorboard", "false"]
TOOL_WAVS = 8           # 8c: phase 3b's prompts p0..p7 (16 kHz, 3 s)


def tts_model(seed, **kw):
    """A seeded Transformer TTS on the card, eval mode, the stop head's
    bias at -30: a lane stops only past 10 x its text length."""
    import torch

    from valle_tpu_torch.models.transformer import (TransformerTtsConfig,
                                                    TransformerTtsModel)

    gen = torch.Generator("cuda").manual_seed(seed)
    model = TransformerTtsModel(TransformerTtsConfig(**dict(TTS, **kw)),
                                generator=gen)
    with torch.no_grad():
        model.stop_layer.bias.fill_(-30.0)
    return model.eval()


def tts_batch(B, S, T, seed, short_lane=False):
    """Seeded text (B, S) and fbank-like features (B, T, 100) on the card,
    lengths spread below the widths; ``short_lane`` gives row 1 a 2-token
    text."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    lens = torch.tensor([S - 7 * i for i in range(B)], device="cuda")
    if short_lane:
        lens[1] = 2
    return {"text": torch.randint(3, 60, (B, S), generator=gen,
                                  device="cuda"),
            "text_lens": lens,
            "audio": torch.randn(B, T, TTS["num_mel_bins"], generator=gen,
                                 device="cuda") - 4.0,
            "audio_lens": torch.tensor([T - 9 * i for i in range(B)],
                                       device="cuda")}


def rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def check_tts_fp32(info):
    """8a: each scaling_xformers x norm_first model at 2 layers, card vs
    CPU and switch on vs off; returns nothing, raises on a miss."""
    import torch

    from valle_tpu_torch.models.transformer import transformer_tts_forward
    from valle_tpu_torch.ops import cuda_build as cb

    res = {}
    for sx in (False, True):
        for nf in (True, False):
            name = f"scaling {sx}, norm_first {nf}"
            model = tts_model(20 + 2 * sx + nf, num_layers=2,
                              scaling_xformers=sx, norm_first=nf)
            cpu = copy.deepcopy(model).cpu()
            sm = TTS_SMALL
            b = tts_batch(sm["B"], sm["S"], sm["T"], 8, short_lane=True)
            bc = {k: v.cpu() for k, v in b.items()}
            loss, m = transformer_tts_forward(model, b, deterministic=True)
            lossc, mc = transformer_tts_forward(cpu, bc, deterministic=True)
            errs = {k: abs(m[k].item() - mc[k].item())
                    / max(abs(mc[k].item()), 1e-30) for k in m}
            errs["loss"] = abs(loss.item() - lossc.item()) / abs(
                lossc.item())
            mel, lens = model.inference(b["text"], b["text_lens"],
                                        max_gen_len=sm["G"])
            melc, lensc = cpu.inference(bc["text"], bc["text_lens"],
                                        max_gen_len=sm["G"])
            mel_err = rel_err(mel.cpu(), melc)
            same_lens = torch.equal(lens.cpu(), lensc)
            sw = TTS_SWITCH
            b2 = tts_batch(sw["B"], sw["S"], sw["T"], 9)
            out = {}
            for on in (True, False):
                flash_switch(on)
                cb.reset_launch_counts()
                l2, _ = transformer_tts_forward(model, b2,
                                                deterministic=True)
                n_fwd = cb.LAUNCHES["flash_attention"]
                cb.reset_launch_counts()
                mel2, _ = model.inference(b2["text"], b2["text_lens"],
                                          max_gen_len=sw["G"])
                out[on] = (l2, mel2, n_fwd, cb.LAUNCHES["flash_attention"])
            flash_switch(False)
            sw_loss = rel_err(out[True][0], out[False][0])
            sw_mel = rel_err(out[True][1], out[False][1])
            want_fwd = (b6_launches(sw["S"], sw["S"], 2)
                        + b6_launches(sw["T"], sw["T"], 2)
                        + b6_launches(sw["T"], sw["S"], 2))
            want_inf = b6_launches(sw["S"], sw["S"], 2)
            launches = (out[True][2], out[True][3], out[False][2],
                        out[False][3])
            log(f"  8a {name}: card vs CPU loss/metrics rel "
                f"{max(errs.values()):.2e} (limit 1e-5), mel rel "
                f"{mel_err:.2e} (limit 1e-4), lens {lens.tolist()} "
                f"{'equal' if same_lens else 'DIFFER'}; switch on vs off "
                f"loss rel {sw_loss:.2e}, mel rel {sw_mel:.2e} (limit "
                f"1e-5), B6 launches forward/inference {launches[:2]} "
                f"(want {(want_fwd, want_inf)}), off {launches[2:]}")
            res[name] = {"card_cpu": errs, "mel_rel": mel_err,
                         "lens": lens.tolist(), "switch_loss_rel": sw_loss,
                         "switch_mel_rel": sw_mel, "launches": launches}
            if (max(errs.values()) > 1e-5 or mel_err > 1e-4
                    or not same_lens or lens[1].item() != 21
                    or sw_loss > 1e-5 or sw_mel > 1e-5
                    or launches != (want_fwd, want_inf, 0, 0)):
                raise RuntimeError(f"8a {name} failed: {res[name]}")
    info["tts_fp32"] = res


def tts_inference_full(model, card, info):
    """8b: bf16 inference at B 8, text 160, 200 frames, switch on: B6 12
    times (the encoder), two timed runs. Returns the launches of one."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cb

    f = TTS_FULL
    b = tts_batch(f["B"], f["S"], 8, 10)
    runs = []
    flash_switch(True)
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            cb.reset_launch_counts()
            t0 = time.perf_counter()
            mel, lens = model.inference(b["text"], b["text_lens"],
                                        max_gen_len=f["G"],
                                        compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0,
                         cb.LAUNCHES["flash_attention"]))
    finally:
        flash_switch(False)
    frames = int(lens.sum())
    want = b6_launches(f["S"], f["S"], f["layers"])
    info["tts_inference"] = {
        "seconds": [r[0] for r in runs], "frames": frames,
        "frames_per_s": [frames / r[0] for r in runs],
        "launches": runs[0][1]}
    log(f"  8b bf16 inference B {f['B']}, text {f['S']}, {f['G']} frames, "
        f"{f['layers']} + {f['layers']} layers: "
        f"{[round(r[0], 3) for r in runs]} s, "
        f"{[round(frames / r[0], 1) for r in runs]} frames/s, B6 launches "
        f"{[r[1] for r in runs]} (want {want}); {card}")
    if (mel.shape != (f["B"], f["G"], TTS["num_mel_bins"])
            or not torch.isfinite(mel).all() or frames != f["B"] * f["G"]
            or any(r[1] != want for r in runs)):
        raise RuntimeError("8b: Transformer TTS inference failed")
    return {"flash_attention": runs[0][1]}


def write_fbank_corpus(root, sizes=TTS_CORPUS, prefix="tts_"):
    """A seeded fbank corpus (manifests under ``root``, the (T, 100)
    features in this process's MemoryStore, or HDF5 where h5py imports):
    ``write_train_corpus``'s layout for the Transformer TTS."""
    import numpy as np

    from valle_tpu_torch.data import manifests
    from valle_tpu_torch.utils.symbol_table import SymbolTable

    try:
        import h5py  # noqa: F401
        store = None
    except ImportError:
        store = _STORE
    rng = np.random.RandomState(SEED + 8)
    letters = list("abcdefghijklmnopqrstuvwxyz_")
    shift = 256.0 / 24000
    for split in ("train", "dev"):
        h5 = root / f"fbank_{split}.h5"
        cuts, arrays = [], {}
        for i in range(sizes[split]):
            T = (sizes["dev_frames"] if split == "dev"
                 else int(rng.randint(*sizes["frames"])))
            key = f"{prefix}{split}_{i:03d}"
            arrays[key] = rng.normal(-4.0, 2.0, (T, TTS["num_mel_bins"])
                                     ).astype(np.float32)
            text = "".join(rng.choice(letters, sizes["text"]))
            cuts.append(manifests.Cut(
                id=key, duration=T * shift, text=text, tokens=list(text),
                speaker=f"spk{i % 4}",
                features=manifests.FeatureRef(str(h5), key, T,
                                              TTS["num_mel_bins"], shift)))
        if store is None:
            with manifests.Hdf5FeatureStore(h5).writer() as w:
                for key, a in arrays.items():
                    w.write(key, a)
        else:
            store.update(arrays)
        manifests.CutSet(cuts).to_file(root / f"cuts_{split}.jsonl.gz")
    table = SymbolTable()
    for sym in ["<pad>", "<bos>", "<eos>"] + letters:
        table.add(sym)
    table.to_file(root / "unique_text_tokens.k2symbols")
    if store is not None:
        manifests._cached_store = lambda path: store


def tts_trainer(d, card, info):
    """8b: the trainer CLI, 3 bf16 steps and a validation pass under the
    switch. Returns (RunStats, the launches)."""
    import torch

    from valle_tpu_torch.bin import trainer
    from valle_tpu_torch.ops import cuda_build as cb

    corpus, exp = d / "tts_corpus", d / "tts_exp"
    corpus.mkdir()
    write_fbank_corpus(corpus)
    argv = ["--manifest-dir", str(corpus), "--text-tokens",
            str(corpus / "unique_text_tokens.k2symbols"), "--exp-dir",
            str(exp)] + TTS_FLAGS
    flash_switch(True)
    try:
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        stats = trainer.run(trainer.get_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        flash_switch(False)
    got = cb.LAUNCHES["flash_attention"]
    want = 3 * TTS_FULL["layers"] * stats.valid_batches
    losses = [m[0] / max(m[1], 1) for m in stats.step_metrics]
    ms = stats.loop_seconds / max(stats.steps, 1) * 1e3
    info["tts_trainer"] = {
        "wall_s": wall, "steps": stats.steps,
        "batch_shapes": stats.batch_shapes,
        "valid_batches": stats.valid_batches, "ms_per_step": ms,
        "loss_per_frame": losses, "launches": got, "expected": want,
        "checkpoint_writes": [{"name": n, "s": sec, "bytes": b} for
                              n, sec, b in stats.checkpoint_writes]}
    log(f"  8b trainer: {stats.steps} steps (rows, text, frames) "
        f"{stats.batch_shapes}, loss/frame {[round(x, 2) for x in losses]}, "
        f"{ms:.1f} ms/step, validation {stats.valid_batches} batches, "
        f"B6 launches {got} (want {want}), {wall:.1f} s in all; {card}")
    if (stats.steps != 3 or stats.valid_batches == 0 or got != want
            or not all(map(math.isfinite, losses))):
        raise RuntimeError("8b: the Transformer TTS trainer run failed")
    return stats, exp, {"flash_attention": got}


def check_visualize_outputs(model, info):
    """8b: the --visualize inputs on the card: the Transformer's (encoder
    output, predicted mel) and VALL-E's (NAR text frontend, codes), finite
    and shaped."""
    import torch

    from valle_tpu_torch.models.transformer import (
        transformer_visualize_outputs)
    from valle_tpu_torch.models.valle import (VALLE, ValleConfig,
                                              valle_visualize_outputs)

    b = tts_batch(4, 48, 96, 11)
    enc, pred = transformer_visualize_outputs(model, b)
    valle = VALLE(ValleConfig(**dict(FULL, num_layers=1)),
                  generator=torch.Generator("cuda").manual_seed(12))
    codes = torch.randint(0, 1024, (4, 96, 8), device="cuda")
    venc, vcodes = valle_visualize_outputs(valle, {"text": b["text"],
                                                   "audio": codes})
    shapes = [tuple(x.shape) for x in (enc, pred, venc, vcodes)]
    ok = (shapes == [(4, 48, TTS["d_model"]), (4, 96, TTS["num_mel_bins"]),
                     (4, 48, FULL["d_model"]), (4, 96, 8)]
          and all(torch.isfinite(x.float()).all() for x in (enc, pred,
                                                            venc))
          and torch.equal(vcodes, codes))
    log(f"  8b visualize outputs: shapes {shapes}, finite {ok}")
    info["visualize_outputs"] = shapes
    if not ok:
        raise RuntimeError("8b: visualize outputs failed")


def check_tools(cli_dir, exp, info):
    """8c: the tokenizer's batch extraction card vs CPU, verify_encodec on
    the seeded codec, export_torch of 8b's checkpoint."""
    import io

    import numpy as np
    import torch

    from valle_tpu_torch import native
    from valle_tpu_torch.bin import export_torch, tokenizer, verify_encodec
    from valle_tpu_torch.data.manifests import Cut, RecordingRef
    from valle_tpu_torch.models import load_model

    cuts = []
    for i in range(TOOL_WAVS):
        path = cli_dir / f"p{i}.wav"
        w, sr = native.read_wav(str(path))
        cuts.append(Cut(id=f"p{i}", duration=w.shape[0] / sr,
                        recording=RecordingRef(str(path), sr, w.shape[0])))
    res = {}
    for name in ("Encodec", "Fbank"):
        ext = {dev: tokenizer.make_extractor(
            name, weights_path=str(cli_dir / "codec.th"), device=dev)[0]
            for dev in ("cuda", "cpu")}
        t0 = time.perf_counter()
        card = tokenizer.encode_cuts(ext["cuda"], cuts, device="cuda")
        t1 = time.perf_counter()
        host = tokenizer.encode_cuts(ext["cpu"], cuts, device="cpu")
        t2 = time.perf_counter()
        if name == "Encodec":
            score = float(np.mean([(a == b).mean()
                                   for a, b in zip(card, host)]))
            ok = score >= CODE_SHARE
        else:
            score = max(float(np.abs(a - b).max())
                        for a, b in zip(card, host))
            ok = score <= 1e-4
        shapes = sorted({a.shape for a in card})
        res[name] = {"score": score, "card_s": t1 - t0, "cpu_s": t2 - t1,
                     "shapes": [list(x) for x in shapes]}
        log(f"  8c tokenizer {name}, {TOOL_WAVS} x 3 s wavs: "
            f"{'codes equal share' if name == 'Encodec' else 'max abs'} "
            f"{score:.6g} card vs CPU, shapes {shapes}, card "
            f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")
        if not ok or [a.shape for a in card] != [b.shape for b in host]:
            raise RuntimeError(f"8c: the tokenizer's {name} disagrees")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify_encodec.main(["--weights", str(cli_dir / "codec.th"),
                                  "--golden", str(cli_dir / "none.npz")])
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  8c verify_encodec: {line}")
    res["verify_encodec"] = {"rc": rc, "lines": lines}
    if (rc != 1 or len(lines) != 7 or "FAIL: SNR" not in lines[4]
            or lines[-1] != "FAIL"):
        raise RuntimeError("8c: verify_encodec did not run its checks")
    t0 = time.perf_counter()
    rc = export_torch.main([str(exp / "epoch-1.pt"), str(exp / "ref.pt")])
    back, _ = load_model(str(exp / "ref.pt"), device="cpu")
    want = torch.load(str(exp / "epoch-1.pt"), map_location="cpu",
                      weights_only=False)["model"]
    same = (rc == 0 and back.state_dict().keys() == want.keys()
            and all(torch.equal(v, want[k])
                    for k, v in back.state_dict().items()))
    size = (exp / "ref.pt").stat().st_size
    log(f"  8c export_torch of epoch-1.pt: {size / 2**30:.3f} GiB, loads "
        f"back equal {same}, {time.perf_counter() - t0:.1f} s")
    res["export_torch"] = {"bytes": size, "equal": same}
    info["tools"] = res
    if not same:
        raise RuntimeError("8c: export_torch did not round-trip")


def run_transformer_tts(cli_dir, card, info):
    """Phase 8. TF32 stays off. Returns the Transformer's B6 launches
    (8b: the inference and the trainer's validation)."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log_phase(" 8a: fp32, d 1024, 16 heads, 2 layers")
    check_tts_fp32(info)
    log_phase(f" 8b: bf16 at full width ({TTS_FULL['layers']} + "
              f"{TTS_FULL['layers']} layers)")
    model = tts_model(30, num_layers=TTS_FULL["layers"])
    n = sum(p.numel() for p in model.parameters())
    log(f"  8b model: {n / 1e6:.1f}M parameters")
    check_visualize_outputs(model, info)
    inf = tts_inference_full(model.to(torch.bfloat16), card, info)
    del model
    torch.cuda.empty_cache()
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_tts_"))
    try:
        _, exp, val = tts_trainer(d, card, info)
        torch.cuda.empty_cache()
        log_phase(" 8c: the tools")
        check_tools(cli_dir, exp, info)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    info["phase8_s"] = time.perf_counter() - t0
    log(f"  phase 8 took {info['phase8_s']:.1f} s; {card}")
    return {"inference": inf["flash_attention"],
            "validation": val["flash_attention"]}


# ---------------------------------------------------------------------------
# phase 9: serving over several devices, the recipe
# ---------------------------------------------------------------------------

MESH_REQUESTS = 16      # 9a/9b Synthesizer batches: 8 rows a shard
MESH_FP32_GEN = 16      # 9a's Synthesizer budget
MESH_CB_FP32_GEN = 48   # 9a's ContinuousBatcher budget
MESH_BF16_GEN = 64      # 9b's Synthesizer budget
MESH_CB_GEN = 64        # 9b's ContinuousBatcher budget (1-2 character
                        # texts: 16x caps of 49 and 65 frames)
MESH_RUNS = 3           # 9b's timed runs of each engine
MESH_MODES = (("exact", 1), ("fused", 1), ("mega", 1), ("int8", 1),
              ("exact", 5))
RECIPE_FLAGS = dict(
    num_epochs_ar="1", num_epochs_nar="3", max_duration_ar="8",
    max_duration_nar="8",
    model_args=("--model-name valle --share-embedding true --norm-first "
                "true --add-prenet false --decoder-dim 64 --nhead 4 "
                "--num-decoder-layers 1 --prefix-mode 1"),
    train_extra=("--warmup-steps 2 --accumulate-grad-steps 1 --num-buckets "
                 "2 --valid-interval 4 --filter-min-duration 0.1 "
                 "--max-steps-per-epoch 3 --num-workers 0 --tensorboard "
                 "false"),
    infer_extra="--text-extractor char --max-gen-len 16",
    demo_text="hello from the port")
# the calls of h5py's File that the port's feature store makes, over a
# pickled dict, for a host without h5py (9d's recipe subprocesses only)
H5PY_STAND_IN = '''"""h5py.File's calls of valle_tpu_torch's feature store
over a pickled dict (written by chip_smoke.py for a host without h5py)."""
import os
import pickle

import numpy as np


class File(dict):
    def __init__(self, path, mode="r"):
        super().__init__()
        self.path, self.mode = str(path), mode
        if mode != "w" and os.path.exists(self.path):
            with open(self.path, "rb") as f:
                self.update(pickle.load(f))

    def create_dataset(self, key, data):
        self[key] = np.asarray(data)

    def close(self):
        if self.mode != "r":
            with open(self.path, "wb") as f:
                pickle.dump(dict(self), f)
'''


def mesh_devices():
    """Two shards: cuda:0 and cuda:1 where there are two cards, else
    cuda:0 twice."""
    import torch

    return (["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2
            else ["cuda:0", "cuda:0"])


def mesh_requests(n, seed, frames, lo=4, hi=30):
    import numpy as np

    from valle_tpu_torch.serving import SynthesisRequest

    rng = np.random.RandomState(seed)
    return [SynthesisRequest(text=t, prompt_codes=rng.randint(
        0, 1024, (frames, 8))) for t in cb_texts(n, seed, lo=lo, hi=hi)]


def shard_counts():
    """{shard: {kernel: launches}} of the last mesh run, launched kernels
    only."""
    from valle_tpu_torch.ops import cuda_build as cbk

    return {i: {k: v for k, v in c.items() if v}
            for i, c in sorted(cbk.SHARD_LAUNCHES.items())}


def check_both_shards(label, kernels, counts):
    for k in kernels:
        for i in (0, 1):
            if counts.get(i, {}).get(k, 0) <= 0:
                raise RuntimeError(f"{label}: {k} never launched on shard "
                                   f"{i}: {counts}")


def code_share(got, ref):
    """The share of equal codes over two runs' requests, each padded to
    the longer run with codes that never match."""
    import numpy as np

    eq = tot = 0
    for a, b in zip(got, ref):
        n = max(a.frames, b.frames)
        m = min(a.frames, b.frames)
        eq += int((a.codes[:m] == b.codes[:m]).sum())
        tot += n * 8
    return eq / max(tot, 1)


def add_launches(total, counts):
    for per in counts.values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v


def check_mesh_fp32(model32, audio_tok, mesh, info):
    """9a: the mesh Synthesizer at fp32 against mesh=None in each of
    MESH_MODES (greedy, then sampled "exact"), and the mesh
    ContinuousBatcher against mesh=None, greedy."""
    import torch

    from valle_tpu_torch.ops import cuda_build as cbk

    reqs = mesh_requests(MESH_REQUESTS, 9, 64)
    res, launches = {}, {}
    for mode, top_k in MESH_MODES:
        engines = [build_synth(model32, audio_tok, mode,
                               max_gen_len=MESH_FP32_GEN, top_k=top_k,
                               compute_dtype=torch.float32, mesh=m)
                   for m in (None, mesh)]
        t0 = time.perf_counter()
        ref = engines[0].synthesize(reqs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cbk.reset_launch_counts()
        got = engines[1].synthesize(reqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = shard_counts()
        add_launches(launches, counts)
        check_results(got, MESH_REQUESTS)
        ran = engines[1].last_decode_mode
        share = code_share(got, ref)
        label = f"{mode} top_k {top_k}"
        log(f"  fp32 {label}, {MESH_REQUESTS} requests: mesh ran {ran!r} "
            f"in {t2 - t1:.3f} s, mesh=None {t1 - t0:.3f} s; codes equal "
            f"{share:.4f}; frames {[r.frames for r in got]}; launches by "
            f"shard {counts}")
        if ran != mode:
            raise RuntimeError(f"mesh {label}: ran {ran!r}")
        if mode == "int8":
            if share < CODE_SHARE:
                raise RuntimeError(f"mesh int8: {share:.4f} of codes equal "
                                   f"mesh=None's (< {CODE_SHARE})")
        elif share != 1.0 or [r.frames for r in got] != [r.frames
                                                         for r in ref]:
            raise RuntimeError(f"mesh {label}: codes differ from "
                               f"mesh=None's ({share:.4f} equal)")
        if mode != "exact":
            check_both_shards(f"mesh {label}", MODE_KERNELS.get(
                mode, INFERENCE_KERNELS[:2]), counts)
        res[label] = {"ran": ran, "share": share, "mesh_s": t2 - t1,
                      "one_s": t1 - t0, "launches": counts}
    reqs = [r for r in mesh_requests(CB_REQUESTS, 6, 225)]
    engines = [cb_engine(model32, audio_tok, torch.float32,
                         max_gen_len=MESH_CB_FP32_GEN, mesh=m)
               for m in (None, mesh)]
    ref = engines[0].run(reqs)
    cbk.reset_launch_counts()
    got = engines[1].run(reqs)
    torch.cuda.synchronize()
    counts = shard_counts()
    add_launches(launches, counts)
    check_cb_results(got, CB_REQUESTS, MESH_CB_FP32_GEN)
    share = code_share(got, ref)
    log(f"  fp32 ContinuousBatcher, {CB_REQUESTS} requests, slots "
        f"{CB['slots']} (4 a shard): codes equal mesh=None's {share:.4f}, "
        f"frames {[r.frames for r in got]}, steps "
        f"{engines[1].last_stats['steps']} (mesh=None "
        f"{engines[0].last_stats['steps']}); launches by shard {counts}")
    if share != 1.0 or [r.frames for r in got] != [r.frames for r in ref]:
        raise RuntimeError("mesh ContinuousBatcher: results differ from "
                           "mesh=None's")
    check_both_shards("mesh ContinuousBatcher", ("flash_mha_fwd",), counts)
    res["continuous"] = {"share": share, "launches": counts}
    res["launches"] = launches
    info["mesh_fp32"] = res


def time_mesh_bf16(model, audio_tok, mesh, card, info, launches):
    """9b: bf16, greedy, in turns (mesh=None, mesh, mesh, mesh=None, ...):
    the Synthesizer in "fused" on 16 requests with 225-frame prompts, and
    the ContinuousBatcher on 24 mixed-length requests; wall seconds, their
    median and spread, and AR frames/s."""
    import statistics

    import torch

    from valle_tpu_torch.ops import cuda_build as cbk

    reqs16 = mesh_requests(MESH_REQUESTS, 10, 225)
    reqs24 = mesh_requests(CB_REQUESTS, 6, 225, lo=1, hi=2)
    cases = {
        "synthesizer fused": ([static_engine(
            model, audio_tok, torch.bfloat16, "fused", MESH_BF16_GEN,
            mesh=m) for m in (None, mesh)], "synthesize", reqs16,
            INFERENCE_KERNELS),
        "continuous": ([cb_engine(model, audio_tok, torch.bfloat16,
                                  max_gen_len=MESH_CB_GEN, mesh=m)
                        for m in (None, mesh)], "run", reqs24,
                       ("flash_mha_fwd",)),
    }
    res = {}
    for name, (engines, call, reqs, kernels) in cases.items():
        walls = {"mesh=None": [], "mesh": []}
        frames = {}
        for turn in range(2 * MESH_RUNS):
            which = (0, 1, 1, 0)[turn % 4]
            label = ("mesh=None", "mesh")[which]
            torch.cuda.synchronize()
            cbk.reset_launch_counts()
            t0 = time.perf_counter()
            out = getattr(engines[which], call)(reqs)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            frames[label] = sum(r.frames for r in out)
            check_results([r for r in out if r.frames], sum(
                1 for r in out if r.frames))
            if which == 1:
                counts = shard_counts()
                add_launches(launches, counts)
                check_both_shards(f"bf16 mesh {name}", kernels, counts)
        row = {}
        for label, w in walls.items():
            med = statistics.median(w)
            row[label] = {"wall_s": w, "median_s": med,
                          "spread_s": max(w) - min(w),
                          "frames": frames[label],
                          "ar_frames_per_s": frames[label] / med}
            log(f"  bf16 {name}, {len(reqs)} requests, {label}: median "
                f"{med:.3f} s (runs {', '.join(f'{x:.3f}' for x in w)}), "
                f"{frames[label]} frames, {frames[label] / med:.1f} "
                f"frames/s; {card}")
        res[name] = row
    info["mesh_bf16"] = res


def serve_with_dp(d, model, audio_tok, card, info):
    """9c: ``serve --dp`` through the CLI (``--dp 2`` on two cards, else
    ``--dp 1``, and ``--dp 2`` refused), and a two-shard Synthesizer
    behind ``make_server`` in this process."""
    import os
    import threading

    import numpy as np
    import torch

    from valle_tpu_torch.bin.serve import make_server
    from valle_tpu_torch.parallel.mesh import make_mesh

    two_cards = torch.cuda.device_count() >= 2
    dp = 2 if two_cards else 1
    rng = np.random.RandomState(12)
    bodies = [{"text": t, "prompt_codes": rng.randint(
        0, 1024, (225, 8)).tolist()} for t in TEXTS[:4]]
    res = {}

    def post_all(port):
        answers = [None] * len(bodies)

        def post(i):
            try:
                answers[i] = http_post(port, bodies[i])
            except Exception as e:        # noqa: BLE001 - checked below
                answers[i] = e

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        for a in answers:
            if isinstance(a, Exception):
                raise RuntimeError(f"a request failed: {a!r}")
        return [check_wav_answer(a) for a in answers], wall

    root = Path(__file__).resolve().parent
    # on one card, `--dp 2` is started beside the server: it must exit
    refusal = None if two_cards else subprocess.Popen(
        [sys.executable, "-m", "valle_tpu_torch.bin.serve", "--checkpoint",
         str(d / "m.pt"), "--dp", "2"] + SERVE_FLAGS, cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(root)))
    proc, logf = start_server(d, ["--mode", "static", "--decode-mode",
                                  "fused", "--dp", str(dp), "--max-gen-len",
                                  str(MESH_BF16_GEN)], f"serve_dp{dp}")
    try:
        port, secs = server_port(proc, logf)
        frames, wall = post_all(port)
    finally:
        code = stop_server(proc)
    log(f"  serve --dp {dp} (static, fused): up in {secs:.1f} s, "
        f"{len(bodies)} concurrent requests in {wall:.3f} s, frames "
        f"{frames}, exit code {code}; {card}")
    if code:
        raise RuntimeError(f"serve --dp {dp} exited {code}")
    res[f"cli_dp{dp}"] = {"wall_s": wall, "frames": frames}
    if refusal is not None:
        out = refusal.communicate(timeout=300)[0]
        msg = out.strip().splitlines()[-1:]
        log(f"  serve --dp 2 on one card: exit code {refusal.returncode}, "
            f"{msg}")
        if refusal.returncode == 0 or "exceeds the 1 available" not in out:
            raise RuntimeError("serve --dp 2 on one card was not refused")
        res["cli_dp2_refused"] = msg
    synth = static_engine(model, audio_tok, torch.bfloat16, "fused",
                          MESH_BF16_GEN,
                          mesh=make_mesh(dp=2, devices=mesh_devices()))
    server, worker = make_server(synth.synthesize, port=0,
                                 prepare_fn=synth.prepare,
                                 info={"mode": "static", "dp": 2})
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        frames, wall = post_all(server.server_address[1])
    finally:
        server.shutdown()
        worker.stop()
        server.server_close()
        worker.join(timeout=60)
    log(f"  two-shard Synthesizer behind make_server: {len(bodies)} "
        f"concurrent requests in {wall:.3f} s, frames {frames}")
    res["in_process_dp2"] = {"wall_s": wall, "frames": frames}
    info["serve_dp"] = res


def write_libritts_corpus(root):
    """A seeded LibriTTS-layout corpus: 8 train, 2 dev and 2 test
    utterances of 1.5-2.3 s at 24 kHz with their normalized texts."""
    import numpy as np

    from valle_tpu_torch import native

    rng = np.random.RandomState(13)
    for part, n in (("train-clean-100", 8), ("dev-clean", 2),
                    ("test-clean", 2)):
        for i in range(n):
            spk, book = 100 + i % 4, 200 + i
            d = root / part / str(spk) / str(book)
            d.mkdir(parents=True, exist_ok=True)
            uid = f"{spk}_{book}_000001_000000"
            t = np.arange(int((1.5 + 0.12 * i) * 24000)) / 24000
            w = (0.3 * np.sin(2 * np.pi * (150 + 10 * i) * t)
                 + 0.04 * rng.randn(t.size)).astype(np.float32)
            native.write_wav(str(d / f"{uid}.wav"), w, 24000)
            (d / f"{uid}.normalized.txt").write_text(
                " ".join(cb_texts(1, 100 + i, lo=10, hi=40)))


def start_recipe():
    """9d, started: ``egs/libritts/run_torch.sh`` with ``device=cuda`` from
    stage 1 to stage 6 on a seeded synthetic corpus in a subprocess (its
    output to a file). Returns what ``finish_recipe`` takes."""
    import os

    root = Path(__file__).resolve().parent
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_recipe_"))
    atexit.register(shutil.rmtree, d, True)
    write_libritts_corpus(d / "LibriTTS")
    env = dict(os.environ, stage="1", stop_stage="6",
               corpus_dir=str(d / "LibriTTS"), text_extractor="char",
               data_dir=str(d / "data"), exp_dir=str(d / "exp"),
               train_parts="train-clean-100", device="cuda",
               **RECIPE_FLAGS)
    try:
        import h5py  # noqa: F401
        store = "h5py"
    except ImportError:
        (d / "shim").mkdir()
        (d / "shim" / "h5py.py").write_text(H5PY_STAND_IN)
        env["PYTHONPATH"] = f"{d / 'shim'}:{env.get('PYTHONPATH', '')}"
        store = "a pickle stand-in for h5py.File (no h5py here)"
    logf = open(d / "recipe.log", "w")
    proc = subprocess.Popen(["bash", str(root / "egs/libritts/run_torch.sh")],
                            env=env, stdout=logf, stderr=subprocess.STDOUT,
                            start_new_session=True)
    return {"dir": d, "proc": proc, "log": logf, "store": store,
            "t0": time.perf_counter()}


def abort_recipe(job):
    """Stop 9d's script (another part of phase 9 failed)."""
    import os
    import signal

    if job["proc"].poll() is None:
        os.killpg(job["proc"].pid, signal.SIGKILL)
        job["proc"].wait()
    job["log"].close()
    shutil.rmtree(job["dir"], ignore_errors=True)


def finish_recipe(job, card, info):
    """9d, joined: the script must exit 0 within 900 s of its start,
    having written epoch-1.pt (3 AR steps), epoch-3.pt (the stage switch
    into 3 NAR steps) and the demo wav from the best checkpoint."""
    import os
    import signal

    d, proc = job["dir"], job["proc"]
    try:
        try:
            proc.wait(timeout=max(1.0, 900 - (time.perf_counter()
                                              - job["t0"])))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        wall = time.perf_counter() - job["t0"]
        job["log"].close()
        out = (d / "recipe.log").read_text()
        if Path("chiprun_out").is_dir():
            (Path("chiprun_out") / "recipe.log").write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"run_torch.sh exited {proc.returncode}:\n"
                               f"{out[-4000:]}")
        exp = d / "exp"
        ckpts = sorted(p.name for p in exp.glob("*.pt"))
        for need in ("epoch-1.pt", "epoch-3.pt"):
            if need not in ckpts:
                raise RuntimeError(f"run_torch.sh wrote no {need}: {ckpts}")
        frames = check_wav(exp / "demos" / "0.wav")
        log(f"  run_torch.sh stages 1-6 on the card: {wall:.1f} s from its "
            f"start (beside 9a and 9c), feature store {job['store']}; "
            f"checkpoints {ckpts}; demo wav {frames} frames; {card}")
        for line in out.splitlines():
            if line.startswith("Stage"):
                log(f"    {line}")
        info["recipe"] = {"wall_s": wall, "store": job["store"],
                          "checkpoints": ckpts, "demo_frames": frames}
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)


def run_mesh(cli_dir, card, info):
    """Phase 9 on phase 3b's checkpoint and codec in ``cli_dir``. Returns
    the bf16 mesh runs' launches (9b), both shards."""
    import torch

    from valle_tpu_torch.data.tokenizer import AudioTokenizer
    from valle_tpu_torch.models import load_model
    from valle_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    devs = mesh_devices()
    mesh = make_mesh(dp=2, devices=devs)
    where = ("two cards" if devs[0] != devs[1]
             else "one card, both shards on cuda:0")
    log(f"  mesh of two shards on {where} ({devs}); {card}")
    model32, _ = load_model(str(cli_dir / "m.pt"), device="cuda")
    audio_tok = AudioTokenizer(weights_path=str(cli_dir / "codec.th"),
                               device="cuda")
    launches = {}
    # 9d runs in a subprocess beside 9a and 9c, and is joined before 9b's
    # timings
    recipe = start_recipe()
    try:
        log_phase(" 9a: fp32 mesh against one device (9d started beside "
                  "it)")
        check_mesh_fp32(model32, audio_tok, mesh, info)
        model = model32.to(torch.bfloat16)
        del model32
        log_phase(" 9c: serve --dp")
        serve_with_dp(cli_dir, model, audio_tok, card, info)
    except BaseException:
        abort_recipe(recipe)
        raise
    log_phase(" 9d: egs/libritts/run_torch.sh on the card, joined")
    finish_recipe(recipe, card, info)
    log_phase(" 9b: bf16 mesh beside one device")
    time_mesh_bf16(model, audio_tok, mesh, card, info, launches)
    del model, audio_tok
    torch.cuda.empty_cache()
    info["phase9_s"] = time.perf_counter() - t0
    info["mesh"] = {"devices": devs, "where": where}
    log(f"  phase 9 took {info['phase9_s']:.1f} s; {card}")
    return launches


def card_name_and_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else "nvidia-smi unavailable")


# ---------------------------------------------------------------------------


def main() -> int:
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if os.environ.get(DP_ENV):
        return dp_worker(os.environ[DP_ENV])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from valle_tpu_torch.ops import cuda_build as cb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path("chiprun_out")
    info = {"device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"device {info['device']}, torch {info['torch']}, "
        f"cuda {info['cuda']}")

    log_phase("phase 1: build")
    t0 = time.perf_counter()
    cb.load_library()
    info["build_s"] = time.perf_counter() - t0
    log(f"  kernels built and loaded in {info['build_s']:.2f} s "
        f"(nvcc {cb.build_info['seconds']}) -> {cb.build_info['path']}")
    info["ptxas"] = [line.strip() for line in
                     cb.build_info["log"].splitlines()
                     if "Compiling entry" in line or "registers" in line
                     or "spill" in line or "error" in line]
    for line in info["ptxas"]:
        if "Compiling entry" not in line:
            log("  ptxas:", line)

    log_phase("phase 2: kernels vs plain versions")
    errs = {k: [] for k in KERNELS}
    errs.update({n + "@dh128": [] for n in DH128_KERNELS})
    check_kernels(errs)
    check_decode_kernels(errs)
    check_int8_edges(errs)
    check_attention_kernels(errs, info)
    check_train_kernels(errs, DH128["H"], DH128["Dh"], "@dh128",
                        ("ar", "unseen row"))

    log_phase("phase 3: end to end through Synthesizer")
    from valle_tpu_torch.data.tokenizer import AudioTokenizer
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    gen = torch.Generator("cuda").manual_seed(0)
    model32 = VALLE(ValleConfig(**FULL), generator=gen).eval()
    check_reference(model32, info)
    check_int8_long(info)
    check_flash_switch_fp32(model32, info)
    audio_tok = AudioTokenizer(device="cuda", seed=0)
    cli_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    atexit.register(shutil.rmtree, cli_dir, True)
    write_cli_files(model32, audio_tok, cli_dir)
    model = model32.to(torch.bfloat16)
    del model32
    reqs = run_e2e(model, audio_tok, info)
    mode_launches = run_decode_modes(model, audio_tok, reqs, info)
    switch_launches = run_flash_switch(model, audio_tok, reqs, info)
    switch_dh128 = run_flash_switch_dh128(audio_tok, reqs, info)
    transposed_launches = run_transposed_modes(model, info)
    dh128_modes = run_dh128_decode_modes(audio_tok, reqs, info)
    log_phase(" 3b: prompt wav through the CLI")
    check_encoder(audio_tok, cli_dir, info)
    run_cli(cli_dir, info)
    run_prompt_wav_batch(model, audio_tok, cli_dir, info)
    torch.cuda.empty_cache()
    log_phase("phase 4: timings")
    time_ar(model, info)
    time_nar(model, info)
    time_codec(audio_tok, info)
    times, bounds, library = {}, {}, {}
    time_kernels(times, bounds, library)
    time_decode_kernels(times, bounds, library, info)
    time_attention_kernels(times, bounds, library, info)
    device_busy(model, info)
    info["ar_step_kernels"] = ar_step_kernels(model)
    del model, audio_tok
    torch.cuda.empty_cache()

    log_phase("phase 5: training")
    log_phase(" 5a: flash forward + backward kernels vs plain versions")
    check_train_kernels(errs)
    pack = packed_corpus()
    check_packed_kernels(errs, pack, info)
    log_phase(" 5b: fp32 train step at full width, flash vs einsum")
    check_train_step_fp32(info)
    check_train_step_fp32(info, " (Dh 128, 2 layers)", **DH128_MODEL)
    log_phase(" 5c: full-width bf16 training at the recipe shapes")
    model = VALLE(ValleConfig(**dict(FULL, **DH128_MODEL)),
                  generator=torch.Generator("cuda").manual_seed(3))
    dh128_train = train_full_width(model, info, " (Dh 128, 2 layers)")
    del model
    model = VALLE(ValleConfig(**FULL),
                  generator=torch.Generator("cuda").manual_seed(1))
    train_full_width(model, info)
    log_phase(" 5d: timings")
    time_train_steps(model, info)
    time_train_kernels(times, bounds, library)
    time_train_kernels(times, bounds, library, DH128["H"], DH128["Dh"],
                       "@dh128")
    del model
    torch.cuda.empty_cache()

    card = card_name_and_limit()
    info["nvidia_smi"] = card
    log_phase(" 5e: the trainer on the card")
    trainer_launches = train_with_the_cli(card, info)
    log_phase(" 5f: sequence-packed training")
    check_packed_fp32(pack, info)
    packed_launches = train_packed_with_the_cli(pack, card, info)
    log_phase(" 5g: data parallel")
    dp_launches = train_data_parallel(pack, card, info)
    log_phase("phase 6: continuous batching and the HTTP server")
    cb_launches = run_continuous_batching(cli_dir, info)
    log_phase("phase 7: VALL-F, prenets, post-norm")
    v_synth, v_train = run_variants(cli_dir, card, info)
    log_phase("phase 8: Transformer TTS and the tools")
    tts_launches = run_transformer_tts(cli_dir, card, info)
    log_phase("phase 9: serving over several devices, the recipe")
    mesh_launches = run_mesh(cli_dir, card, info)
    shutil.rmtree(cli_dir, ignore_errors=True)

    # launches of each kernel's timed (bf16) instance on the path it
    # serves, and where they were counted ("launches_from")
    launches, sources = dict(info["launches_synthesis"]), {}
    for n in ("fused_ln_qkv", "fused_tail"):
        sources[n] = "Synthesizer, decode modes fused (8 requests) and " \
                     "fused_w8 (4)"
    dh128_note = " (d 1024, 8 heads, 2 layers)"
    for n in ("flash_mha_fwd", "flash_mha_bwd"):
        launches[n] = trainer_launches[n] + packed_launches[n] + \
            dp_launches[n]
        launches[n + "@dh128"] = sum(run[n] for run in dh128_train.values())
        sources[n] = ("the trainer CLI at full width, 6 layers: stage 1 + "
                      "stage 2 "
                      "(5e), packed stage 1 + stage 2 (5f), and every rank "
                      "of the data-parallel runs (5g)")
        sources[n + "@dh128"] = (f"bf16 train steps, AR + NAR, "
                                 f"{TRAIN_STEPS} each" + dh128_note)
    for n in DECODE_KERNELS:
        launches[n] = sum(run[n] for run in mode_launches.values())
        sources[n] = "Synthesizer, the attention-kernel decode modes"
    launches["flash_mha_fwd"] += cb_launches["flash_mha_fwd"]
    sources["flash_mha_fwd"] += (", and ContinuousBatcher's NAR passes "
                                 "(6b, 24 requests, and the same with EOS "
                                 "endings)")
    launches["flash_attention"] = (switch_launches["flash_attention"]
                                   + cb_launches["flash_attention"])
    launches["flash_attention@dh128"] = switch_dh128["flash_attention"]
    sources["flash_attention"] = ("Synthesizer, one switch-on batch "
                                  "(prefill + 7 NAR passes), and one "
                                  "switch-on ContinuousBatcher run of 12 "
                                  "requests (6b: its prefill waves + 7 NAR "
                                  "passes a group)")
    sources["flash_attention@dh128"] = sources["flash_attention"] + \
        dh128_note
    # B7: no path calls it (as in the JAX package)
    for n in ("flash_attention_lens", "flash_attention_lens@dh128"):
        launches[n] = info["flash_attention_lens_bf16_check_launches"][n]
        sources[n] = "this script's bf16 checks; no path calls it"
    for mode, _, n in TRANSPOSED_RUNS:
        launches[n] = transposed_launches[mode][n]
        sources[n] = f"valle_ar_decode, decode mode {mode}"
        launches[n + "@dh128"] = dh128_modes[mode][n]
        sources[n + "@dh128"] = sources[n] + dh128_note
    launches["fused_attn_tail@dh128"] = dh128_modes["mega"]["fused_attn_tail"]
    n = "decode_attention_int8_grouped"
    launches[n + "@dh128"] = dh128_modes["int8"][n]
    sources[n + "@dh128"] = ("Synthesizer, decode mode int8 (8 requests)"
                             + dh128_note)
    sources["fused_attn_tail@dh128"] = ("Synthesizer, decode mode mega (8 "
                                        "requests)" + dh128_note)
    # phase 7's paths: the post-norm prenet VALL-E (7b, 7c), VALL-F (7b)
    post = {"decode_attention_int8_grouped": "postnorm_int8",
            "decode_attention_kv": "postnorm_bf16",
            "decode_attention_lanes": "postnorm_lanes",
            "decode_attention": "postnorm_per_sample",
            "decode_attention_grouped": "postnorm_grouped"}
    for n, run in post.items():
        launches[n] += v_synth[run][n]
        sources[n] += (", and a post-norm prenet model's run in that mode "
                       "(7b)")
    launches["flash_mha_fwd"] += sum(
        v_synth[f"postnorm_{m}"]["flash_mha_fwd"] for m in POSTNORM_MODES)
    for n in ("flash_mha_fwd", "flash_mha_bwd"):
        launches[n] += sum(v_train[f"postnorm_stage{s}"][n] for s in (1, 2))
    sources["flash_mha_fwd"] += (", a post-norm prenet model's NAR passes "
                                 "(7b, 4 Synthesizer batches)")
    for n in ("flash_mha_fwd", "flash_mha_bwd"):
        sources[n] += (f", and its {VARIANT_STEPS} train steps of stages 1 "
                       "and 2 (7c)")
    launches["flash_attention"] += v_synth["vallf"]["flash_attention"]
    sources["flash_attention"] += (", and one switch-on VALL-F batch (7b: "
                                   "its prefill's and NAR passes' "
                                   "self-attention)")
    launches["flash_attention"] += sum(tts_launches.values())
    sources["flash_attention"] += (", and the Transformer TTS (8b: a bf16 "
                                   "inference's encoder, and the trainer "
                                   "CLI's validation pass)")
    for n, v in mesh_launches.items():
        launches[n] += v
        sources[n] += (", and the two-shard serving mesh's bf16 runs (9b: "
                       "the Synthesizer in fused, the ContinuousBatcher's "
                       "NAR passes)")
    entries = dict(KERNELS)
    entries.update({n + "@dh128": KERNELS[n] for n in DH128_KERNELS})
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "launches_from": sources[n],
                "max_abs_err": max(errs[n]),
                "ms": times[n][0], "plain_ms": times[n][1],
                "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
                "library_ms": library[n]}
               for n, (src, rep) in entries.items()]
    info["kernels"] = kernels
    info["kernel_times"] = times
    info["library_times"] = library
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
