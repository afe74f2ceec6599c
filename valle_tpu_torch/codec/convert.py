"""Load EnCodec 24 kHz weights of the ``encodec`` package (mirror of
``valle_tpu/codec/convert.py``).

The package's state dict carries weight norm
(``encoder.model.{i}.conv.conv.{weight_g,weight_v,bias}``,
``decoder.model.{i}.convtr.convtr.*``, ``...lstm.*``,
``quantizer.vq.layers.{q}._codebook.embed``). The port's ``EncodecModel``
already uses these names, so importing is folding each ``weight_g`` /
``weight_v`` pair into a plain ``weight`` (the norm over every dim but 0,
in numpy float32 as the JAX package folds it) and a strict load.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import EncodecModel

# buffers the package's codebooks keep for their k-means updates in
# training; encoding and decoding read only ``embed``
_TRAINING_BUFFERS = ("inited", "cluster_size", "embed_avg")


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.astype(np.float32)
    return t.detach().cpu().numpy().astype(np.float32)


def import_encodec_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """An encodec-package state dict (or a checkpoint holding it under
    ``"model"``) -> the port's ``EncodecModel`` state dict, weight norm
    folded, float32 on the CPU."""
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.endswith(".weight_v"):
            continue
        if key.endswith(".weight_g"):
            prefix = key[: -len(".weight_g")]
            g, v = _np(value), _np(sd[f"{prefix}.weight_v"])
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
            out[f"{prefix}.weight"] = torch.from_numpy(g * v / norm)
        elif not ("._codebook." in key
                  and key.rsplit(".", 1)[-1] in _TRAINING_BUFFERS):
            out[key] = torch.from_numpy(_np(value))
    return out


def load_encodec_torch(path: str, *, device="cuda") -> EncodecModel:
    """An EnCodec 24 kHz checkpoint file (torch ``.th`` / ``.pt``) -> the
    port's ``EncodecModel`` on ``device``, loaded with ``strict=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    model = EncodecModel()
    model.load_state_dict(import_encodec_state_dict(sd), strict=True)
    return model.to(device).eval()
