"""The slice on the CPU, decode mode "exact": the port's greedy
fp32 codes equal the JAX package's over prefix modes 0/1/2/4 x NAR
einsum/flash. The JAX side runs decode mode "exact" with
the same NAR path (any Pallas kernel it reaches in interpret mode)."""

import pytest

from torch_port_helpers import check_slice_case
from torch_port_helpers import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("nar_attn_impl", ["einsum", "flash"])
@pytest.mark.parametrize("prefix_mode", [0, 1, 2, 4])
def test_slice_codes_equal_jax(prefix_mode, nar_attn_impl):
    check_slice_case(prefix_mode, False, "exact", nar_attn_impl)
