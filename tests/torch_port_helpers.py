"""Shared pieces of the PyTorch-port tests (tests/test_torch_port_*.py).

Inputs are made from a seed with numpy and handed to both the JAX package
and the port; JAX stays on the CPU and its Pallas kernels run in
interpret mode, as the JAX package's own tests run them.
"""

import dataclasses
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
    # the options that shape no parameter share one init
    params = _jax_params(seed, dataclasses.replace(
        jcfg, prefix_mode=0, attn_impl="einsum"))
    model = VALLE(ValleConfig(**kw))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    load_numpy_state_dict(model, valle_state_dict_from_jax(np_params, jcfg))
    return jcfg, params, model.eval()


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    out = torch.from_numpy(np.array(x))
    return out.to(dtype) if dtype is not None else out


# per-row text and prompt shortfalls: unequal lengths, and row 1's 2-token
# text makes the 16x stop rule fire inside a 40-frame budget
_TEXT_LENS = np.array([16, 2, 9, 16, 12, 5, 14, 7], np.int32)
_PROMPT_SHORT = np.array([0, 3, 0, 6, 2, 0, 4, 1], np.int32)


def slice_inputs(seed: int = 0, rows: int = 2, S: int = 16, P: int = 12):
    """A batch of ``rows`` (2, or 8 for the JAX package's 8-row grouped
    decode modes) with text width ``S`` and prompt width ``P``."""
    rng = np.random.RandomState(seed)
    return {"text": rng.randint(3, 60, (rows, S)).astype(np.int32),
            "text_lens": _TEXT_LENS[:rows].copy(),
            "prompt_codes": rng.randint(0, 1024, (rows, P, 8)).astype(
                np.int32),
            "prompt_lens": (P - _PROMPT_SHORT[:rows]).astype(np.int32),
            "enroll": np.array([5, 2, 3, 4, 2, 3, 5, 2], np.int32)[:rows]}


@functools.lru_cache(maxsize=None)
def _jax_slice(prefix_mode, prepend_bos, decode_mode, nar_attn_impl,
               rows=2, S=16, P=12, nhead=SMALL["nhead"]):
    from valle_tpu.models.inference import valle_inference as jax_inference

    jcfg, params, _ = make_pair(prefix_mode=prefix_mode,
                                prepend_bos=prepend_bos, nhead=nhead)
    x = slice_inputs(rows=rows, S=S, P=P)
    codes, lens = jax_inference(
        params, jcfg, *(jnp.asarray(x[n]) for n in SLICE_ARGS),
        top_k=1, max_gen_len=40, decode_mode=decode_mode,
        nar_attn_impl=nar_attn_impl)
    return np.asarray(codes), np.asarray(lens)


SLICE_ARGS = ("text", "text_lens", "prompt_codes", "prompt_lens", "enroll")


def check_slice_case(prefix_mode, prepend_bos, decode_mode, nar_attn_impl,
                     *, rows=2, S=16, P=12, nhead=SMALL["nhead"],
                     min_share=1.0):
    """Greedy fp32 ``valle_inference``: the port's codes and lengths equal
    the JAX package's, with JAX on the same decode mode and the same NAR
    attention path (its Pallas kernels in interpret mode). The int8 modes
    pass ``min_share``: codes equal on at least that share of entries (it
    is printed), lengths equal."""
    from valle_tpu_torch.models.inference import valle_inference

    _, _, model = make_pair(prefix_mode=prefix_mode, prepend_bos=prepend_bos,
                            nhead=nhead)
    x = slice_inputs(rows=rows, S=S, P=P)
    jcodes, jlens = _jax_slice(prefix_mode, prepend_bos, decode_mode,
                               nar_attn_impl, rows, S, P, nhead)
    codes, lens = valle_inference(
        model, *(t(x[n]) for n in SLICE_ARGS), top_k=1, max_gen_len=40,
        decode_mode=decode_mode, nar_attn_impl=nar_attn_impl)
    share = float((codes.numpy() == jcodes).mean())
    print(f"{decode_mode} prefix mode {prefix_mode}, B {rows}: codes equal "
          f"to JAX's on {share:.4f} of entries")
    assert np.array_equal(lens.numpy(), jlens)
    assert share >= min_share
    # row 1 has a 2-token text: the 16x stop rule ends it inside the budget
    assert int(lens[1]) < 40


# ---------------------------------------------------------------------------
# training (tests/test_torch_port_train_*.py)
# ---------------------------------------------------------------------------

TRAIN_SMALL = dict(d_model=64, nhead=4, num_layers=2, num_quantizers=8,
                   max_len=256)
# the NAR draws, pinned on both sides: stage 3; prefix mode 1 length 5 in
# [min_len / 4, min_len / 2) = [4, 8); mode 2 segment starts
TRAIN_PINS = dict(nar_stage=3, nar_prefix_len=5,
                  nar_prefix_starts=np.array([3, 10], np.int32))


def train_batch(seed: int = 0, prefix_mode: int = 0):
    """A 2-row training batch with unequal text and audio lengths."""
    rng = np.random.RandomState(seed)
    B, S, T = 2, 8, 24
    batch = {"text": rng.randint(3, 60, (B, S)).astype(np.int32),
             "text_lens": np.array([8, 5], np.int32),
             "audio": rng.randint(0, 1024, (B, T, 8)).astype(np.int32),
             "audio_lens": np.array([24, 19], np.int32)}
    if prefix_mode == 4:
        batch["prompt_codes"] = rng.randint(0, 1024, (B, 6, 8)).astype(
            np.int32)
        batch["prompt_lens"] = np.array([6, 6], np.int32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_forward_stage0(prefix_mode, prepend_bos, attn_impl):
    """JAX valle_forward at train stage 0 (fp32, deterministic, draws
    pinned): (loss, metrics, grads as the port's state-dict names)."""
    from valle_tpu.models import valle_forward as jax_forward

    jcfg = JaxValleConfig(prefix_mode=prefix_mode, prepend_bos=prepend_bos,
                          attn_impl=attn_impl, **TRAIN_SMALL)
    params = _jax_params(0, dataclasses.replace(
        jcfg, prefix_mode=0, attn_impl="einsum"))
    batch = {k: jnp.asarray(v) for k, v in
             train_batch(prefix_mode=prefix_mode).items()}

    def f(p):
        loss, metrics, _ = jax_forward(
            p, jcfg, batch, train_stage=0, deterministic=True,
            **{k: jnp.asarray(v) for k, v in TRAIN_PINS.items()})
        return loss, metrics

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            valle_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, grads), jcfg))


def check_forward_case(train_stage, prefix_mode, prepend_bos, attn_impl):
    """fp32, deterministic, draws pinned: the port's valle_forward loss and
    metrics equal JAX's to 1e-5 relative, and its gradients JAX's
    ``jax.grad`` to 1e-4 relative (of each tensor's largest entry).

    JAX runs stage 0 once per configuration. With the draws pinned, its
    loss is (ar_loss + nar_loss) / 2, so stage 1's reference is ar_loss
    with twice the AR gradients and zero NAR gradients, and stage 2's
    likewise: exact, since halving and doubling are exact in floating
    point. The port runs each stage's own forward."""
    from valle_tpu_torch.models.valle import valle_forward

    jloss, jmetrics, jgrads = _jax_forward_stage0(prefix_mode, prepend_bos,
                                                  attn_impl)
    branch = {1: ("ar", "ArTop10Accuracy"), 2: ("nar", "NarTop10Accuracy")}
    if train_stage in branch:
        name, acc = branch[train_stage]
        jloss = jmetrics[f"{name}_loss"]
        jmetrics = {k: jmetrics[k] for k in (acc, f"{name}_loss", "frames")}
        jgrads = {k: (2 * g if k.startswith(name + "_") else 0 * g)
                  for k, g in jgrads.items()}
    _, _, model = make_pair(prefix_mode=prefix_mode, prepend_bos=prepend_bos,
                            attn_impl=attn_impl, **TRAIN_SMALL)
    loss, metrics = valle_forward(
        model, {k: t(v) for k, v in
                train_batch(prefix_mode=prefix_mode).items()},
        train_stage=train_stage, deterministic=True,
        **{k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in TRAIN_PINS.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for name, p in model.named_parameters():
        if p.requires_grad:
            got = (p.grad if p.grad is not None else torch.zeros_like(p))
            want = jgrads[name]
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-4,
                atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=name)
