"""Time the flash-attention kernels of two checkouts of this repository in
turns on one GPU, and compare their outputs bit for bit.

Run from the repository root, on the GPU machine, with the other checkout
unpacked somewhere (for example ``git archive <commit> | tar -x -C DIR``):

    python3 chip_ab.py DIR

Four fresh processes run in turns: DIR, this checkout, this checkout, DIR.
Each builds its checkout's kernels and, on the same seeded inputs (bf16,
device time by CUDA-graph replay, best of two graphs of 50 replays; the
helpers of chip_smoke.py):
- B4/B5 (flash_mha_fwd / flash_mha_bwd) at the AR training shape (B 16,
  S = T = 471, AR codes), Dh 64 (16 heads) and Dh 128 (8 heads), dropout
  0.1 and 0;
- B6/B7 (flash_attention / flash_attention_lens) at the NAR-pass (S = T =
  439) and AR-prefill (S = T = 289) shapes, B 8, Dh 64 (16 heads) and Dh
  128 (8 heads);
- B8/B9 (decode_attention / decode_attention_grouped over the transposed
  cache) at the bench decode step (B 32, cache 512, 365 valid keys a row)
  and B8 at B 6, Dh 64 (16 heads) and Dh 128 (8 heads);
- B12 (fused_attn_tail, d_model 1024, FFN 4096, every parameter in bf16)
  at the bench decode step, Dh 64 and Dh 128, and its kernels apart
  (device ms a call by kernel name, from a profiler trace);
- B3 (decode_attention_int8_grouped) at B 32 and 8, caches 512 and 1024
  (365 and 657 valid keys a row), Dh 64 (16 heads) and 128 (8 heads);
  B10/B11 (decode_attention_kv / _lanes) at the bench step, Dh 64 and 128;
- B1/B2 (fused_ln_qkv / fused_tail, B 32, d 1024, FFN 4096, bf16 and int8
  weights; one layer's weights), device time and the eager call's time
  (host launch cost included);
- AR decode ms/step of a full-width bf16 model (seeded weights; B 32,
  text 64, prompt 225, 150 frames) in modes fused and int8: the host-bound
  loop, so it moves with the host's launch cost;
- the static SASS of B3's bf16 Dh-64 kernel (cuobjdump -sass of the built
  library): opcode counts inside its main loop and per key a head;
and a SHA-256 of each output, so that a kernel that was moved rather than
changed shows the same bits. Prints one JSON line per process and the
summary; writes chiprun_out/chip_ab.json. Needs one CUDA device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """This checkout's chip_smoke.py, whichever package is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_one(root: str) -> dict:
    """Times and digests of the kernels of the package under ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from valle_tpu_torch.ops import attention as pa
    from valle_tpu_torch.ops import cuda_build as cb
    from valle_tpu_torch.ops.flash_mha import (flash_mha_backward,
                                               flash_mha_forward)

    cs = _smoke()
    cb.load_library()
    res = {"root": root, "ms": {}, "digest": {}, "eager_ms": {},
           "bound_ms": {},
           "ptxas": [ln.strip() for ln in cb.build_info["log"].splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]}
    best = lambda fn: min(cs.graph_ms(fn) for _ in range(2))  # noqa: E731
    dt = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(61)
    R = cs.AR_RECIPE
    for H, Dh in ((16, 64), (8, 128)):
        q, k, v, g, qc, kc = cs.attn_case(R["B"], R["S"], R["T"], dt, gen,
                                          H=H, Dh=Dh)
        for rate in (0.1, 0.0):
            kw = dict(dropout_rate=rate, seed=cs.SEED if rate else None)
            out, lse = flash_mha_forward(q, k, v, qc, kc, **kw)
            grads = flash_mha_backward(q, k, v, qc, kc, out, lse, g, **kw)
            tag = f"dropout {rate}" + ("" if Dh == 64 else f" Dh {Dh}")
            res["digest"][f"flash_mha_fwd {tag}"] = _digest(out, lse)
            res["digest"][f"flash_mha_bwd {tag}"] = _digest(*grads)
            res["ms"][f"flash_mha_fwd {tag}"] = best(
                lambda: flash_mha_forward(q, k, v, qc, kc, **kw))
            res["ms"][f"flash_mha_bwd {tag}"] = best(
                lambda: flash_mha_backward(q, k, v, qc, kc, out, lse, g,
                                           **kw))
    B, St = cs.PREFILL["B"], cs.PREFILL["S_text"]
    for H, Dh in ((16, 64), (8, 128)):
        for shape in ("nar", "prefill"):
            tag = f"{shape} Dh {Dh}"
            T, bias = cs.attn_bias(shape, gen)
            q, k, v = cs.attn_views(B, T, H, Dh, dt, gen)
            res["digest"][f"flash_attention {tag}"] = _digest(
                pa.flash_attention(q, k, v, bias))
            res["ms"][f"flash_attention {tag}"] = best(
                lambda: pa.flash_attention(q, k, v, bias))
            causal = shape == "prefill"
            T, x_lens, y_lens, _ = cs.lens_case(causal, gen)
            q, k, v = cs.attn_views(B, T, H, Dh, dt, gen)
            fn = lambda: pa.flash_attention_lens(  # noqa: E731
                q, k, v, x_lens, y_lens, St, causal)
            res["digest"][f"flash_attention_lens {tag}"] = _digest(fn())
            res["ms"][f"flash_attention_lens {tag}"] = best(fn)
    decode_ab(cs, res, best, _digest)
    int8_ab(cs, res, best, _digest)
    dense_ab(cs, res, best, _digest)
    ar_ab(cs, res)
    res["sass_b3"] = sass_b3(cb.build_info["path"])
    torch.cuda.synchronize()
    return res


def decode_ab(cs, res, best, digest):
    """B8/B9 and B12 at the bench decode step (see the module docstring)."""
    import torch

    from valle_tpu_torch.ops import decode_attention as dt8
    from valle_tpu_torch.ops import decode_attention_grouped as dt9
    from valle_tpu_torch.ops import decode_attention_lanes as dln
    from valle_tpu_torch.ops import fused_attn_tail as fat

    dt = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(62)
    S = cs.DEC["S"]
    for H, Dh in ((16, 64), (8, 128)):
        q, k, v, x_lens, wp = cs.decode_inputs(dt, gen, spread=False, H=H,
                                               Dh=Dh)
        kt, vt = (x.transpose(-1, -2).contiguous() for x in (k, v))
        for B in (32, 6):
            a = (q[:B], kt[:B], vt[:B], x_lens[:B], wp[:B])
            tag = f"B {B} Dh {Dh}"
            res["digest"][f"decode_attention {tag}"] = digest(
                dt8.decode_attention(*a, S=S))
            res["ms"][f"decode_attention {tag}"] = best(
                lambda: dt8.decode_attention(*a, S=S))
        fn = lambda: dt9.decode_attention_grouped(  # noqa: E731
            q, kt, vt, x_lens, wp, S=S)
        res["digest"][f"decode_attention_grouped B 32 Dh {Dh}"] = digest(fn())
        res["ms"][f"decode_attention_grouped B 32 Dh {Dh}"] = best(fn)
        p = cs.dense_inputs(32, H * Dh, 4096, dt, gen)
        w = cs.dense_weights(p, dt, False)
        vp = {n: p[n].to(dt) for n in ("out_b", "ln_w", "ln_b", "b1", "b2")}
        args = (q, p["h"], dln.combine_kv_lanes(k, v), x_lens, wp,
                w["out_w"], vp["out_b"], vp["ln_w"], vp["ln_b"], w["w1"],
                vp["b1"], w["w2"], vp["b2"])
        res["digest"][f"fused_attn_tail Dh {Dh}"] = digest(
            fat.fused_attn_tail(*args, S=S))
        res["ms"][f"fused_attn_tail Dh {Dh}"] = best(
            lambda: fat.fused_attn_tail(*args, S=S))
        res[f"fused_attn_tail Dh {Dh} kernels"] = cs.kernel_split(
            lambda: fat.fused_attn_tail(*args, S=S))


def int8_ab(cs, res, best, digest):
    """B3 at B 32 / 8, caches 512 / 1024, Dh 64 / 128; B10/B11 at the
    bench step (see the module docstring)."""
    import torch

    from valle_tpu_torch.ops import decode_attention_int8_grouped as d8
    from valle_tpu_torch.ops import decode_attention_kv as dkv
    from valle_tpu_torch.ops import decode_attention_lanes as dln

    gen = torch.Generator("cuda").manual_seed(63)
    S = cs.DEC["S"]
    for H, Dh in ((16, 64), (8, 128)):
        for T, wp_val in ((512, S + 300), (1024, S + 225 + 367)):
            q, k, v = (torch.randn(32, H, n, Dh, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for n in (1, T, T))
            i32 = dict(dtype=torch.int32, device="cuda")
            x_lens = torch.full((32,), S, **i32)
            wp = torch.full((32,), wp_val, **i32)
            caches = cs.decode_caches(k, v)
            i8 = caches["int8"]
            n_key = wp_val - S + 1 + S        # valid keys a row
            for B in (32, 8):
                a = (q[:B], i8[0][:B], i8[1][:B], x_lens[:B], wp[:B])
                tag = f"B {B} T {T} Dh {Dh}"
                fn = lambda: d8.decode_attention_int8_grouped(  # noqa: E731
                    *a, S=S)
                res["digest"][f"int8 {tag}"] = digest(fn())
                res["ms"][f"int8 {tag}"] = best(fn)
                # int8 K|V rows and two fp32 scales a valid key and head;
                # q in, out, the lengths
                res["bound_ms"][f"int8 {tag}"] = cs.roofline(
                    B * n_key * H * (2 * Dh + 8) + B * H * Dh * 4 + 8 * B,
                    4 * B * n_key * H * Dh)[0]
            if T == 512:
                tag = f"B 32 T 512 Dh {Dh}"
                for name, fn in (
                        ("kv", lambda: dkv.decode_attention_kv(
                            q, caches["kv"], x_lens, wp, S=S)),
                        ("lanes", lambda: dln.decode_attention_lanes(
                            q, caches["lanes"], x_lens, wp, S=S,
                            nhead=H))):
                    res["digest"][f"{name} {tag}"] = digest(fn())
                    res["ms"][f"{name} {tag}"] = best(fn)
            del q, k, v, caches, i8


def dense_ab(cs, res, best, digest):
    """B1/B2 at B 32, d 1024, FFN 4096, bf16 and int8 weights."""
    import torch

    from valle_tpu_torch.ops import fused_dense as fd

    dt = torch.bfloat16
    p = cs.dense_inputs(32, 1024, 4096, dt,
                        torch.Generator("cuda").manual_seed(64))
    vp = {n: p[n].to(dt) for n in ("ln_w", "ln_b", "in_b", "out_b", "b1",
                                   "b2")}
    for int8 in (False, True):
        w = cs.dense_weights(p, dt, int8)
        tag = "int8 weights" if int8 else "bf16 weights"
        sc = (w["out_w_s"], w["w1_s"], w["w2_s"]) if int8 else None
        for name, fn in (
                ("fused_ln_qkv", lambda: fd.fused_ln_qkv(
                    p["h"], vp["ln_w"], vp["ln_b"], w["in_w"], vp["in_b"],
                    w_scale=w["in_w_s"])),
                ("fused_tail", lambda: fd.fused_tail(
                    p["a"], p["h"], w["out_w"], vp["out_b"], vp["ln_w"],
                    vp["ln_b"], w["w1"], vp["b1"], w["w2"], vp["b2"],
                    w_scales=sc))):
            res["digest"][f"{name} {tag}"] = digest(fn())
            res["ms"][f"{name} {tag}"] = best(fn)
            res["eager_ms"][f"{name} {tag}"] = min(
                cs.cuda_ms(fn, iters=200) for _ in range(2))


def ar_ab(cs, res):
    """AR decode ms/step, full width, bf16, modes fused and int8."""
    import torch

    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    model = VALLE(ValleConfig(**cs.FULL),
                  generator=torch.Generator("cuda").manual_seed(65))
    model = model.eval().to(torch.bfloat16)
    ar = cs.time_ar_modes(model, 150, ("fused", "int8"))
    res["ar_ms_per_step"] = {m: ar[m]["ms_per_step"] for m in ar}
    del model
    torch.cuda.empty_cache()


def sass_b3(lib_path):
    """Opcode counts of B3's bf16 Dh-64 kernel (this tree's or the
    parent's) inside its main loop, the widest backward branch, and per
    key a head: the loop body runs once a thread for each 128 keys in the
    new kernel (one key a thread), once for each 64 keys in the parent's
    (4 rows of 16 row groups). Static counts: predicated paths count as
    taken."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True).stdout
    funcs = re.split(r"\n\s*Function : ", out)
    name = lambda f: f.split("\n")[0]  # noqa: E731
    new = [f for f in funcs if "decode_int8_kernel" in name(f)
           and "nv_bfloat16Li64E" in name(f)]
    old = [f for f in funcs if "decode_attention_kernel" in name(f)
           and "nv_bfloat16aLi64E" in name(f)]
    if not new and not old:
        return {"error": "B3 kernel not found in the SASS"}
    return dict(sass_loop_counts(new[0] if new else old[0],
                                 128 if new else 64),
                kernel="new" if new else "parent")


def sass_loop_counts(body, keys):
    """Opcodes of one function's SASS inside its widest loop, and per key a
    head (the loop runs once a thread for each ``keys`` keys, 128
    threads)."""
    import re

    ins, labels = [], {}
    pending = []
    for ln in body.splitlines():
        lab = re.match(r"\s*\.?(L_x_\d+):", ln)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", ln)
        if not m:
            continue
        off = int(m.group(1), 16)
        for lb in pending:
            labels[lb] = off
        pending = []
        ins.append((off, m.group(3), m.group(4)))
    loops = []
    for off, op, rest in ins:
        if op.split(".")[0] != "BRA":
            continue
        t = re.search(r"0x([0-9a-f]+)", rest)
        lb = re.search(r"(L_x_\d+)", rest)
        tgt = int(t.group(1), 16) if t else labels.get(lb.group(1)) \
            if lb else None
        if tgt is not None and tgt < off:
            loops.append((tgt, off))
    if not loops:
        return {"error": "no backward branch"}
    lo, hi = max(loops, key=lambda x: x[1] - x[0])
    counts = {}
    for off, op, _ in ins:
        if lo <= off <= hi:
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    per_key = {k: v * 128 / keys for k, v in sorted(counts.items())}
    return {"loop": [lo, hi], "loop_instructions": sum(counts.values()),
            "per_key_head": per_key,
            "per_key_head_all": sum(per_key.values())}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(run_one(argv[2])))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, this = str(Path(argv[1]).resolve()), str(HERE)
    runs = []
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        out = subprocess.run([sys.executable, str(HERE / "chip_ab.py"),
                              "--one", root], capture_output=True, text=True,
                             cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["label"] = label
        print(json.dumps({k: v for k, v in res.items() if k != "ptxas"}))
        runs.append(res)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    summary = {"card": smi, "kernels": {}}
    for name in runs[1]["ms"]:
        a = [r["ms"].get(name) for r in runs if r["label"] == "other"]
        b = [r["ms"][name] for r in runs if r["label"] == "this"]
        a = [x for x in a if x is not None]
        summary["kernels"][name] = {
            "other_ms": min(a) if a else None, "this_ms": min(b),
            "ratio": min(b) / min(a) if a else None,
            "bound_ms": runs[1].get("bound_ms", {}).get(name),
            "same_bits": (runs[0]["digest"].get(name) ==
                          runs[1]["digest"][name]),
            "this_repeatable": runs[1]["digest"][name] ==
                               runs[2]["digest"][name]}
    print(json.dumps(summary, indent=1))
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_ab.json").write_text(json.dumps(
        {"summary": summary, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
