"""Synthesis with VALL-F, prenets and post-norm stacks in the port against
the JAX package (fp32, greedy, 2 layers, d 128, 4 heads, 40 frames,
BatchNorm statistics that are not the fresh ones): codes and lengths bit
for bit from ``valle_inference`` for VALL-F (prefix mode 2, the enrolled
text cut), a prenet VALL-E (the counterpart of
``tests/test_decode_parity.py:172``) and a post-norm VALL-E in "exact"
and "unroll"; ``valle_continual`` on VALL-F."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from valle_tpu.models.inference import valle_continual as jax_continual
from valle_tpu.models.inference import valle_inference as jax_inference
from valle_tpu_torch.models.inference import valle_continual, valle_inference

from torch_port_helpers import SLICE_ARGS, make_variant, slice_inputs, t

GEN = 40
CASES = {  # name: (config overrides, decode mode)
    "vallf": (dict(model_name="vallf", prefix_mode=2), "exact"),
    "prenet": (dict(add_prenet=True, prefix_mode=1), "exact"),
    "postnorm_exact": (dict(norm_first=False), "exact"),
    "postnorm_unroll": (dict(norm_first=False), "unroll"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the trainer tests run: beside the other
    test workers, many small ops on several threads each mostly wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_codes_equal_jax(case):
    overrides, mode = CASES[case]
    jcfg, params, state, model = make_variant(**overrides)
    x = slice_inputs(rows=2)
    jcodes, jlens = jax_inference(
        params, jcfg, *(jnp.asarray(x[n]) for n in SLICE_ARGS), top_k=1,
        max_gen_len=GEN, decode_mode=mode, state=state)
    codes, lens = valle_inference(model, *(t(x[n]) for n in SLICE_ARGS),
                                  top_k=1, max_gen_len=GEN,
                                  decode_mode=mode)
    assert np.array_equal(lens.numpy(), np.asarray(jlens))
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert int(lens[1]) < GEN   # the 16x stop rule ended row 1


def test_vallf_continual_equals_jax():
    jcfg, params, state, model = make_variant(model_name="vallf",
                                              prefix_mode=1)
    rng = np.random.RandomState(0)
    y = rng.randint(0, 1024, (2, 30, 8)).astype(np.int32)
    y_lens = np.array([30, 22], np.int32)
    x = slice_inputs()
    jc, jl = jax_continual(params, jcfg, jnp.asarray(x["text"]),
                           jnp.asarray(x["text_lens"]), jnp.asarray(y),
                           jnp.asarray(y_lens), state=state)
    c, ln = valle_continual(model, t(x["text"]), t(x["text_lens"]), t(y),
                            t(y_lens))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert np.array_equal(ln.numpy(), np.asarray(jl))
