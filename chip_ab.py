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
    res = {"root": root, "ms": {}, "digest": {},
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
