"""Shared pieces of the PyTorch-port tests (tests/test_torch_port_*.py).

Inputs are made from a seed with numpy and handed to both the JAX package
and the port; JAX stays on the CPU and its Pallas kernels run in
interpret mode, as the JAX package's own tests run them.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.models import ValleConfig as JaxValleConfig
from valle_tpu.models import init_valle
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.utils.convert import (load_numpy_state_dict,
                                           valle_state_dict_from_jax)

# d_model 128 is the smallest width fused_dense_supported accepts
SMALL = dict(d_model=128, nhead=4, num_layers=2, num_quantizers=8,
             max_len=512)


@functools.lru_cache(maxsize=None)
def _jax_params(seed: int, jcfg):
    return init_valle(jax.random.PRNGKey(seed), jcfg)[0]


def make_pair(seed: int = 0, **overrides):
    """(JAX cfg, JAX params, port model) sharing the same weights. The JAX
    tree is cached per (seed, cfg); the port model is always new."""
    kw = {**SMALL, **overrides}
    jcfg = JaxValleConfig(**kw)
    params = _jax_params(seed, jcfg)
    model = VALLE(ValleConfig(**kw))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    load_numpy_state_dict(model, valle_state_dict_from_jax(np_params, jcfg))
    return jcfg, params, model.eval()


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    out = torch.from_numpy(np.array(x))
    return out.to(dtype) if dtype is not None else out


def slice_inputs(seed: int = 0):
    """A 2-row batch: unequal text/prompt lengths, one short text so the
    16x-text-length stop rule fires inside the generation budget."""
    rng = np.random.RandomState(seed)
    B, S, P = 2, 16, 12
    return {"text": rng.randint(3, 60, (B, S)).astype(np.int32),
            "text_lens": np.array([16, 2], np.int32),
            "prompt_codes": rng.randint(0, 1024, (B, P, 8)).astype(np.int32),
            "prompt_lens": np.array([12, 9], np.int32),
            "enroll": np.array([5, 2], np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_slice(prefix_mode, prepend_bos, decode_mode, nar_attn_impl):
    from valle_tpu.models.inference import valle_inference as jax_inference

    jcfg, params, _ = make_pair(prefix_mode=prefix_mode,
                                prepend_bos=prepend_bos)
    x = slice_inputs()
    codes, lens = jax_inference(
        params, jcfg, *(jnp.asarray(x[n]) for n in SLICE_ARGS),
        top_k=1, max_gen_len=40, decode_mode=decode_mode,
        nar_attn_impl=nar_attn_impl)
    return np.asarray(codes), np.asarray(lens)


SLICE_ARGS = ("text", "text_lens", "prompt_codes", "prompt_lens", "enroll")


def check_slice_case(prefix_mode, prepend_bos, decode_mode, nar_attn_impl):
    """Greedy fp32 ``valle_inference``: the port's codes and lengths equal
    the JAX package's bit for bit, with JAX on the same decode mode and
    the same NAR attention path."""
    from valle_tpu_torch.models.inference import valle_inference

    _, _, model = make_pair(prefix_mode=prefix_mode, prepend_bos=prepend_bos)
    x = slice_inputs()
    jcodes, jlens = _jax_slice(prefix_mode, prepend_bos, decode_mode,
                               nar_attn_impl)
    codes, lens = valle_inference(
        model, *(t(x[n]) for n in SLICE_ARGS), top_k=1, max_gen_len=40,
        decode_mode=decode_mode, nar_attn_impl=nar_attn_impl)
    assert np.array_equal(lens.numpy(), jlens)
    assert np.array_equal(codes.numpy(), jcodes)
    # row 1 has a 2-token text: the 16x stop rule ends it inside the budget
    assert int(lens[1]) < 40
