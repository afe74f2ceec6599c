"""The slice on the CPU in the combined-KV decode modes ("bf16",
"fused_kv"), B = 8 with two heads of 64: the port's greedy fp32 codes and
lengths equal the JAX package's in the same mode (its kernel in interpret
mode). At B = 2 the grouped modes take the JAX package's substitutes on
both sides."""

import pytest

from torch_port_helpers import check_slice_case


@pytest.mark.parametrize("mode", ["bf16", "fused_kv"])
def test_kv_mode_codes_equal_jax(mode):
    check_slice_case(1, False, mode, "einsum", rows=8, nhead=2)


@pytest.mark.parametrize("mode", ["int8", "mega"])
def test_grouped_modes_at_b2_equal_jax(mode):
    """B = 2: JAX runs "int8" on the exact path and "mega" as "fused";
    the port's resolve_decode_mode does the same, so codes equal JAX's
    bit for bit."""
    check_slice_case(1, False, mode, "einsum")
