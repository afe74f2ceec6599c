"""Resolvers of the model options (mirror of ``valle_tpu/models/__init__.py``
``resolve_score_bf16``, ``resolve_attn_impl``, ``resolve_remat``).

The JAX package's thresholds were measured on a TPU; where the port keeps
them, they wait to be measured again on the H100.
"""

from __future__ import annotations

import torch


def resolve_score_bf16(mode: str) -> bool:
    """``--attn-score-bf16``: "auto" and "on" store attention scores in
    bf16 when the compute dtype is bf16 (inert at fp32); "off" never."""
    if mode in ("auto", "on", "1", "true"):
        return True
    if mode in ("off", "0", "false"):
        return False
    raise ValueError(f"unknown attn-score-bf16 mode {mode!r}")


def resolve_attn_impl(mode: str, model_name: str = "valle", device="cuda",
                      *, head_dim: int) -> str:
    """``--attn-impl``: "auto" is the flash kernels on CUDA where they take
    the model's head dim (``d_model // nhead``; ``FLASH_HEAD_DIMS``), and
    the einsum path otherwise (on the CPU flash would run its plain
    version; einsum computes the same function). VALL-F has no flash path.
    An explicit "flash" at another head dim raises in the kernel's
    wrapper."""
    from ..ops.flash_mha import FLASH_HEAD_DIMS

    if model_name == "vallf":
        return "einsum"
    if mode == "auto":
        return ("flash" if torch.device(device).type == "cuda"
                and head_dim in FLASH_HEAD_DIMS else "einsum")
    if mode in ("einsum", "flash"):
        return mode
    raise ValueError(f"unknown attn-impl {mode!r}")


def resolve_remat(remat: str, train_stage: int) -> str:
    """``--remat``: "auto" is "none" for the NAR stage (train_stage 2) and
    "full" otherwise, the JAX package's per-stage picks. "dots" and
    "scores" are not ported yet."""
    if remat == "auto":
        return "none" if train_stage == 2 else "full"
    if remat in ("full", "none"):
        return remat
    if remat in ("dots", "scores"):
        raise NotImplementedError(
            f"remat {remat!r} is not ported yet (ROADMAP A9)")
    raise ValueError(f"unknown remat policy {remat!r}")
