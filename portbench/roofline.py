"""The chip's peaks and the operations and bytes the port's work needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM. A roofline share
is the least time the chip needs for a call, the larger of its bytes
over the HBM rate and its operations over the peak, over the time it
took. Bytes count each input read once and each output written once;
where the work depends on the lengths, they count what these lengths
need (the valid keys of each row), not the most the shapes could hold.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def roofline_s(nbytes: float, flops: float) -> float:
    """The least seconds the chip needs for ``nbytes`` and ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


# bytes a valid key costs a head in each decode-attention cache kind: K
# and V rows at the stored dtype, plus the int8 cache's fp32 scale each
CACHE_KEY_BYTES = {"int8": lambda dh: 2 * dh + 2 * 4,
                   "bf16": lambda dh: 2 * dh * 2}
# the decode modes whose attention is a kernel: (cache kind, the
# kernel's name in a device trace)
DECODE_ATTN_KERNELS = {
    "int8": ("int8", "decode_int8_kernel"),
    "fused_int8": ("int8", "decode_int8_kernel"),
    "bf16": ("bf16", "decode_attention_kernel"),
    "fused_kv": ("bf16", "decode_attention_kernel"),
    "lanes": ("bf16", "decode_attention_kernel"),
    "fused_lanes": ("bf16", "decode_attention_kernel"),
}


def decode_attn_bytes(valid_keys: Sequence[int], nhead: int, head_dim: int,
                      kind: str) -> int:
    """Bytes of one decode-attention launch (one layer, one step) over
    rows with ``valid_keys`` keys each: their K/V rows (and scales), q
    in and out at bf16, and each row's text length and write position
    (int32)."""
    rows = len(valid_keys)
    per_key = CACHE_KEY_BYTES[kind](head_dim) * nhead
    return (sum(valid_keys) * per_key + rows * nhead * head_dim * 2 * 2
            + rows * 4 * 2)


def decode_attn_flops(valid_keys: Sequence[int], nhead: int,
                      head_dim: int) -> int:
    """q.k and p.v over every valid key of every row."""
    return 4 * sum(valid_keys) * nhead * head_dim


def stack_params(d_model: int, num_layers: int) -> int:
    """Weights of a pre-norm stack that a token's products read: per
    layer the in-projection (3 d^2), the out-projection (d^2) and the
    FFN (8 d^2)."""
    return num_layers * 12 * d_model * d_model


def ar_step_flops(valid_keys: int, d_model: int, num_layers: int,
                  vocab: int) -> int:
    """Model operations of one AR decode step of one live row: every
    product of the stack and the head (2 per weight), attention over its
    valid keys in every layer."""
    return (2 * (stack_params(d_model, num_layers) + vocab * d_model)
            + num_layers * 4 * valid_keys * d_model)
