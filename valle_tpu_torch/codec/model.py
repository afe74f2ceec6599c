"""EnCodec 24 kHz decode: RVQ codes -> waveform (mirror of
``valle_tpu/codec/model.py``). Encode waits for the codec-encoder port."""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .quantization import ResidualVectorQuantizer, rvq_decode
from .seanet import SEANetDecoder, seanet_decoder_apply


@dataclass(frozen=True)
class EncodecConfig:
    sample_rate: int = 24_000
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    num_quantizers: int = 32       # codebooks available
    bins: int = 1024
    lstm_layers: int = 2
    causal: bool = True
    pad_mode: str = "reflect"

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out  # 320

    @property
    def frame_rate(self) -> int:
        return self.sample_rate // self.hop_length  # 75

    def n_q_for_bandwidth(self, bandwidth_khz: float) -> int:
        """bandwidth (kbps) -> number of codebooks (encodec semantics)."""
        per_q_kbps = self.frame_rate * 10 / 1000.0  # 10 bits per frame
        return max(1, int(bandwidth_khz / per_q_kbps))  # 6.0 -> 8


class EncodecModel(nn.Module):
    """Decoder + quantizer under the encodec package's parameter names."""

    def __init__(self, cfg: EncodecConfig = EncodecConfig(), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.decoder = SEANetDecoder(
            channels=cfg.channels, dimension=cfg.dimension,
            n_filters=cfg.n_filters, ratios=cfg.ratios,
            lstm_layers=cfg.lstm_layers)
        self.quantizer = ResidualVectorQuantizer(
            cfg.num_quantizers, cfg.bins, cfg.dimension)
        self._cast = {}     # dtype -> cast copy of the decoder
        self.register_load_state_dict_pre_hook(
            lambda *_: self._cast.clear())
        if generator is not None:
            device = generator.device
            self.to(device)
            self.decoder.reset_parameters(generator)
            self.quantizer.reset_parameters(generator)

    def decoder_as(self, dtype: torch.dtype) -> SEANetDecoder:
        """The decoder in ``dtype``: itself at fp32, else a cast copy made
        at first use and dropped by the next ``load_state_dict``."""
        if dtype == torch.float32:
            return self.decoder
        if dtype not in self._cast:
            self._cast[dtype] = copy.deepcopy(self.decoder).to(dtype)
        return self._cast[dtype]


@torch.no_grad()
def encodec_decode(model: EncodecModel, codes: torch.Tensor, *,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes: (B, F, n_q) -> wav (B, F * 320, 1) float32.

    ``dtype=torch.bfloat16`` runs the SEANet decoder on a bf16 copy of its
    weights (``EncodecModel.decoder_as``); the RVQ embedding sum and the
    returned waveform stay fp32.
    """
    cfg = model.cfg
    z = rvq_decode(model.quantizer, codes).to(dtype)
    wav = seanet_decoder_apply(model.decoder_as(dtype), z, causal=cfg.causal,
                               pad_mode=cfg.pad_mode)
    return wav.float()
