"""EnCodec 24 kHz: encode wav -> RVQ codes, decode codes -> wav (mirror of
``valle_tpu/codec/model.py``). Weights of the ``encodec`` package load
through ``codec/convert.py``."""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .quantization import ResidualVectorQuantizer, rvq_decode, rvq_encode
from .seanet import (SEANetDecoder, SEANetEncoder, seanet_decoder_apply,
                     seanet_encoder_apply)


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
    """Encoder, decoder and quantizer under the encodec package's parameter
    names."""

    def __init__(self, cfg: EncodecConfig = EncodecConfig(), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(
            channels=cfg.channels, dimension=cfg.dimension,
            n_filters=cfg.n_filters, ratios=cfg.ratios,
            lstm_layers=cfg.lstm_layers)
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
            self.encoder.reset_parameters(generator)

    def decoder_as(self, dtype: torch.dtype) -> SEANetDecoder:
        """The decoder in ``dtype``: itself at fp32, else a cast copy made
        at first use and dropped by the next ``load_state_dict``."""
        if dtype == torch.float32:
            return self.decoder
        if dtype not in self._cast:
            self._cast[dtype] = copy.deepcopy(self.decoder).to(dtype)
        return self._cast[dtype]


@contextlib.contextmanager
def no_tf32():
    """fp32 products in full precision: cuDNN (convolutions, the LSTM) and
    matmuls take TF32 off for the block and restore the settings after.
    TF32 moves the latents by ~1e-3 of their largest entry, enough to
    flip RVQ codes."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev


@torch.no_grad()
def encodec_encode(model: EncodecModel, wav: torch.Tensor,
                   n_q: int = 8) -> torch.Tensor:
    """wav: (B, T, 1) float32 in [-1, 1] -> codes (B, ceil(T / 320), n_q)
    int32. fp32 only, as in the JAX package, and without TF32."""
    if wav.dtype != torch.float32:
        raise ValueError(f"encodec_encode takes float32 wavs, not "
                         f"{wav.dtype}")
    cfg = model.cfg
    with no_tf32():
        z = seanet_encoder_apply(model.encoder, wav, causal=cfg.causal,
                                 pad_mode=cfg.pad_mode)
        return rvq_encode(model.quantizer, z, n_q)


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
