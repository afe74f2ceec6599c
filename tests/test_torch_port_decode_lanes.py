"""The slice on the CPU in the lane-row decode modes ("lanes",
"fused_lanes", "mega"), B = 8 with two heads of 64: the port's greedy
fp32 codes and lengths equal the JAX package's in the same mode (its
kernels in interpret mode)."""

import pytest

from torch_port_helpers import check_slice_case


@pytest.mark.parametrize("prefix_mode", [0, 1, 2, 4])
def test_lanes_codes_equal_jax(prefix_mode):
    check_slice_case(prefix_mode, False, "lanes", "einsum", rows=8, nhead=2)


@pytest.mark.parametrize("mode", ["fused_lanes", "mega"])
def test_fused_lane_modes_codes_equal_jax(mode):
    check_slice_case(1, False, mode, "einsum", rows=8, nhead=2)
