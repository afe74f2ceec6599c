"""The decode-attention kernel's share of its roofline over the traced
AR steps: the least time the chip needs for the bytes (and operations)
each launch must move, summed, over the kernel's device time. A launch
of step g reads every row's valid keys, text plus prompt plus g + 1
audio keys, at the cache's stored dtype (int8 with an fp32 scale under
``int8``, the B3 kernel; bf16 under the modes of B10/B11), with q and
the output. Counted from the batch the call sent."""

from portbench.roofline import (DECODE_ATTN_KERNELS, decode_attn_bytes,
                                decode_attn_flops, roofline_s)


def read(data):
    t = data["trace"]
    if not t:
        return None
    ctx, m = t["ctx"], data["cfg"]["model"]
    if ctx["mode"] not in DECODE_ATTN_KERNELS:
        return None
    kind, kernel = DECODE_ATTN_KERNELS[ctx["mode"]]
    events = [e for name, evs in t["kernels"].items() if kernel in name
              for e in evs]
    if not events:
        return None
    H, L = m["nhead"], m["num_layers"]
    Dh = m["d_model"] // H
    bound = 0.0
    for g in range(ctx["g0"], ctx["g0"] + ctx["n"]):
        keys = [x + p + g + 1 for x, p in zip(ctx["x_lens"], ctx["p_lens"])]
        bound += L * roofline_s(decode_attn_bytes(keys, H, Dh, kind),
                                decode_attn_flops(keys, H, Dh))
    # launches the slice holds beyond or short of n steps x L layers
    bound *= len(events) / (ctx["n"] * L)
    return 100.0 * bound / sum(d for _, d in events)
