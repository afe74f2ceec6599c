"""Seeded weights, made on the device in one draw per model.

Each model's tensors are slices of one ``randn`` buffer drawn with a
generator on the device, in the type the model is served in (the
configuration's ``dtype``), then scaled in place by the rules below.
The names and shapes come from the model's plain reference
(``reference/<model_name>.py``). Both the program and the plain
reference take these tensors; the reference reads them in float32, so
the two start from the same numbers.

VALL-E (the configuration's ``init``): token embeddings N(0, 1), alphas
1, norm gains 1 + 0.1 N(0, 1), biases 0.02 N(0, 1), other matrices
N(0, 1 / fan_in). Then the stop token is kept from winning (the
configuration's ``eos_suppression``): one feature ``dim`` of the AR
stack's final norm is made the constant ``bias`` (gain 0), every AR head
row but EOS's ignores that feature, and EOS's row is ``-1`` there and 0
elsewhere, so the EOS logit is ``-bias`` at every step and each request
runs to the length rule (16 x its text tokens).

EnCodec: convolutions N(0, 1 / fan_in), LSTM matrices and biases
N(0, 1 / (3 H)) (the variance of PyTorch's uniform init), codebooks
N(0, 1), other biases 0.02 N(0, 1); the decoder's last convolution
scaled by ``final_gain`` so that the waveform stays inside [-1, 1].
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .reference import encodec as ref_codec
from .reference import model_reference


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for draw ``stream`` of run ``seed``."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def _draw(shapes: Dict[str, Tuple[int, ...]], seed: int, stream: int,
          device, dtype) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(stream_seed(seed, stream))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[off: off + n].view(shape)
        off += n
    return out


@torch.no_grad()
def model_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's tensors of ``cfg`` (a configuration file's dict) for
    ``seed``, the tied heads the same tensors as their embeddings; the
    stop token held off where the configuration has an
    ``eos_suppression``."""
    model = cfg["model"]
    ref = model_reference(model["model_name"])
    tied = ref.tied_heads(model)
    shapes = {k: v for k, v in ref.parameter_shapes(model).items()
              if k not in tied}
    sd = _draw(shapes, seed, 0, device, getattr(torch, cfg["dtype"]))
    init = cfg["init"]
    for name, t in sd.items():
        if name.endswith("word_embeddings.weight"):
            t.mul_(init["embedding_std"])
        elif name.endswith(".alpha"):
            t.fill_(1.0)
        elif t.ndim == 1 and name.endswith(".weight"):
            t.mul_(init["norm_gain_std"]).add_(1.0)
        elif t.ndim == 1:
            t.mul_(init["bias_std"])
        else:
            t.mul_(1.0 / math.sqrt(t.shape[-1]))
    for k, v in tied.items():
        sd[k] = sd[v]
    eos = cfg.get("eos_suppression")
    if eos is None:
        return sd
    j, V = eos["dim"], model["num_audio_tokens"]
    norm = "ar_decoder.norm"
    sd[norm + ".weight"][j] = 0.0
    sd[norm + ".bias"][j] = eos["bias"]
    head = sd["ar_predict_layer.weight"]
    head[:, j] = 0.0
    head[V] = 0.0
    head[V, j] = -1.0
    return sd


@torch.no_grad()
def codec_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The EnCodec tensors of ``cfg`` for ``seed``, float32."""
    codec = cfg["codec"]
    sd = _draw(ref_codec.parameter_shapes(codec), seed, 1, device,
               torch.float32)
    for name, t in sd.items():
        if name.endswith("_codebook.embed"):
            continue
        if ".lstm." in name:
            hidden = t.shape[0] // 4
            t.mul_(1.0 / math.sqrt(3 * hidden))
        elif name.endswith(".bias"):
            t.mul_(codec["init"]["bias_std"])
        else:
            t.mul_(1.0 / math.sqrt(math.prod(t.shape[1:])))
    last = ref_codec.decoder_layout(codec)[-1][1]
    for part in ("weight", "bias"):
        sd[f"decoder.model.{last}.conv.conv.{part}"].mul_(
            codec["init"]["final_gain"])
    return sd
