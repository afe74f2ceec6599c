"""valle_forward of the port against the JAX package (attention flash): fp32
loss, metrics and gradients over train stages x prefix modes; see
torch_port_helpers.check_forward_case for what and how close."""

import pytest

from torch_port_helpers import check_forward_case


@pytest.mark.parametrize("prefix_mode", [0, 1, 2, 4])
@pytest.mark.parametrize("train_stage", [0, 1, 2])
def test_valle_forward_matches_jax(train_stage, prefix_mode):
    check_forward_case(train_stage, prefix_mode, False, "flash")
