"""Training checkpoints in the upstream reference's ``.pt`` layout.

The JAX package saves orbax directories (``valle_tpu/utils/checkpoint.py
:376-489``), which need jax. The port writes what the reference's trainer
writes (icefall's ``save_checkpoint``): one ``torch.save`` file holding
``model`` (the state dict under the reference's names), ``optimizer``,
``model_avg`` (float64, when averaging), ``sampler`` (the loader's
state) and, at the top level, the run's parameters, among them the model
flags under their flag names (``decoder_dim``, ``nhead``,
``num_decoder_layers``, ``prefix_mode``, ...). ``models.load_model`` and
the JAX package's ``load_torch_checkpoint`` rebuild the model from such
a file alone. Every tensor in it is whole: a trainer under tensor
parallelism gathers its shards before it writes (``bin/trainer.py``), as
JAX's checkpoints hold global arrays.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch


def save_checkpoint(path, *, model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[dict] = None,
                    model_avg: Optional[Dict[str, torch.Tensor]] = None,
                    sampler_state: Optional[dict] = None,
                    params: Optional[dict] = None) -> int:
    """Write one checkpoint file; returns its size in bytes.

    The file is written under a temporary name and renamed, so a process
    stopped mid-write leaves the previous file (or none), never a torn
    one. ``params`` entries go to the top level, as the reference does;
    they may not shadow the four fixed keys."""
    ckpt = {"model": model_state}
    if optimizer_state is not None:
        ckpt["optimizer"] = optimizer_state
    if model_avg is not None:
        ckpt["model_avg"] = model_avg
    if sampler_state is not None:
        ckpt["sampler"] = sampler_state
    for k, v in (params or {}).items():
        if k in ckpt:
            raise ValueError(f"run parameter {k!r} shadows a checkpoint "
                             "entry")
        ckpt[k] = str(v) if isinstance(v, Path) else v
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path.stat().st_size


def load_checkpoint(path) -> dict:
    """The checkpoint's dict, tensors on the CPU."""
    return torch.load(str(path), map_location="cpu", weights_only=False)


def remove_checkpoints(out_dir, keep_last_k: int) -> None:
    """Prune ``checkpoint-<step>.pt``, keeping the newest k (reference
    trainer.py:716-738)."""
    if keep_last_k <= 0:
        return
    root = Path(out_dir)
    steps = sorted(int(p.stem.split("-")[1])
                   for p in root.glob("checkpoint-*.pt")
                   if p.stem.split("-")[1].isdigit())
    for s in steps[:-keep_last_k]:
        (root / f"checkpoint-{s}.pt").unlink(missing_ok=True)
