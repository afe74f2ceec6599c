"""The slice on the CPU, decode mode "exact", prepend_bos: the port's greedy
fp32 codes equal the JAX package's over prefix modes 0/1/2/4 x NAR
einsum/flash. The JAX side runs decode mode "exact" with
the same NAR path (any Pallas kernel it reaches in interpret mode)."""

import pytest

from torch_port_helpers import check_slice_case


@pytest.mark.parametrize("nar_attn_impl", ["einsum", "flash"])
@pytest.mark.parametrize("prefix_mode", [0, 1, 2, 4])
def test_slice_codes_equal_jax(prefix_mode, nar_attn_impl):
    check_slice_case(prefix_mode, True, "exact", nar_attn_impl)
