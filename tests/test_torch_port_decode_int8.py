"""The slice on the CPU in the int8 KV-cache decode modes, B = 8 with two
heads of 64 (the bench model's head width; the JAX kernels unroll their
heads, so fewer heads compile faster): the port's greedy fp32
``valle_inference`` against the JAX package's in the same mode (JAX's
int8 kernel in interpret mode, the port's plain version). Lengths equal
and at least 98% of codes equal (the share is printed; both sides
quantize the cache the same way, so 100% is expected); ``auto`` on a long
cache runs int8 on both sides."""

import pytest

from valle_tpu_torch.models.inference import resolve_decode_mode
from valle_tpu_torch.models.valle import ValleConfig

from torch_port_helpers import SMALL, check_slice_case


@pytest.mark.parametrize("prefix_mode", [0, 1, 2, 4])
def test_int8_codes_agree_with_jax(prefix_mode):
    check_slice_case(prefix_mode, False, "int8", "einsum", rows=8,
                     nhead=2, min_share=0.98)


def test_fused_int8_codes_agree_with_jax():
    check_slice_case(1, False, "fused_int8", "einsum", rows=8, nhead=2,
                     min_share=0.98)


def test_auto_on_a_long_cache_runs_int8_like_jax():
    """Text width 160, prompt width 448, 40 frames: a cache of 650 >= 640
    rows, every position inside the 512-row PE table."""
    assert resolve_decode_mode("auto", ValleConfig(**SMALL), B=8, S=160,
                               P=448, max_gen_len=40) == "int8"
    check_slice_case(1, False, "auto", "einsum", rows=8, nhead=2, S=160,
                     P=448, min_share=0.98)
