"""The model operations of the traced AR steps over the slice's time at
the chip's bf16 peak: every product of the stack and the head for each
row still producing frames (not the grid's padding rows, nor rows past
their length), and attention over each such row's valid keys. The slice
holds AR steps only; the prefill, the NAR passes and the codec are not
in it."""

from portbench.roofline import BF16_FLOPS, ar_step_flops


def read(data):
    t = data["trace"]
    if not t or not t.get("window_s"):
        return None
    ctx, m = t["ctx"], data["cfg"]["model"]
    flops = 0
    for g in range(ctx["g0"], ctx["g0"] + ctx["n"]):
        rows = zip(ctx["x_lens"], ctx["p_lens"], ctx["gen_lens"])
        for x, p, f in list(rows)[:ctx["rows"]]:
            if g < f:
                flops += ar_step_flops(x + p + g + 1, m["d_model"],
                                       m["num_layers"],
                                       m["num_audio_tokens"] + 1)
    return 100.0 * flops / (t["window_s"] * BF16_FLOPS)
