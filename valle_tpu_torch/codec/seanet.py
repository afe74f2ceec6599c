"""SEANet encoder and decoder (EnCodec's convolutional nets), mirror of
``valle_tpu/codec/seanet.py``.

Parameter names follow the ``encodec`` package with weight norm folded
(``encoder.model.{i}.conv.conv.weight``, ``...convtr.convtr.weight``,
``...lstm.weight_ih_l0``). Convolutions, transposed convolutions and the
LSTM are PyTorch's own operators: the JAX package computes them outside
any Pallas kernel too. Public functions keep the JAX layout (B, T, C);
the modules run in PyTorch's (B, C, T) internally.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _extra_padding(length: int, k_eff: int, stride: int,
                   padding_total: int) -> int:
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - padding_total)
    return max(ideal - length, 0)


def _pad1d_reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """x: (B, C, T). Reflect padding with encodec's small-input guard (pad
    with zeros first when T <= max(left, right))."""
    T = x.shape[-1]
    m = max(left, right)
    extra = m - T + 1 if m >= T else 0
    if extra:
        x = F.pad(x, (0, extra))
    out = F.pad(x, (left, right), mode="reflect")
    if extra:
        out = out[..., : out.shape[-1] - extra]
    return out


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, dilation=dilation)


class _ConvTr(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.convtr = nn.ConvTranspose1d(cin, cout, k, stride=stride)


class SConv1d(nn.Module):
    """Streaming-safe causal conv (encodec SConv1d)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv = _Conv(cin, cout, k, dilation)
        self.stride = stride

    def forward(self, x, causal: bool = True, pad_mode: str = "reflect"):
        conv = self.conv.conv
        k_eff = (conv.kernel_size[0] - 1) * conv.dilation[0] + 1
        padding_total = k_eff - self.stride
        extra = _extra_padding(x.shape[-1], k_eff, self.stride,
                               padding_total)
        if causal:
            left, right = padding_total, extra
        else:
            right = padding_total // 2 + extra
            left = padding_total - padding_total // 2
        if pad_mode == "reflect":
            x = _pad1d_reflect(x, left, right)
        else:
            x = F.pad(x, (left, right))
        return F.conv1d(x, conv.weight, conv.bias, stride=self.stride,
                        dilation=conv.dilation)


class SConvTranspose1d(nn.Module):
    """Streaming-safe transposed conv (encodec SConvTranspose1d)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.convtr = _ConvTr(cin, cout, k, stride)
        self.stride = stride

    def forward(self, x, causal: bool = True, trim_right_ratio: float = 1.0):
        ct = self.convtr.convtr
        y = F.conv_transpose1d(x, ct.weight, ct.bias, stride=self.stride)
        padding_total = ct.kernel_size[0] - self.stride
        if causal:
            pr = math.ceil(padding_total * trim_right_ratio)
        else:
            pr = padding_total // 2
        pl = padding_total - pr
        return y[..., pl: y.shape[-1] - pr]


class SLSTM(nn.Module):
    """encodec SLSTM: multi-layer LSTM with a skip connection."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers)

    def forward(self, x):                      # (B, C, T)
        xt = x.permute(2, 0, 1)                # (T, B, C)
        self.lstm.flatten_parameters()         # cuDNN wants one weight chunk
        y, _ = self.lstm(xt)
        return (y + xt).permute(1, 2, 0)


class SEANetResnetBlock(nn.Module):
    def __init__(self, dim: int, compress: int = 2, k_res: int = 3):
        super().__init__()
        hidden = dim // compress
        self.block = nn.ModuleList([nn.ELU(), SConv1d(dim, hidden, k_res),
                                    nn.ELU(), SConv1d(hidden, dim, 1)])
        self.shortcut = SConv1d(dim, dim, 1)

    def forward(self, x, causal=True, pad_mode="reflect"):
        y = self.block[1](F.elu(x), causal, pad_mode)
        y = self.block[3](F.elu(y), causal, pad_mode)
        return self.shortcut(x, causal, pad_mode) + y


@torch.no_grad()
def seeded_init(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's bounds (``init_conv1d``,
    ``init_convtr1d``, ``init_lstm``)."""
    for m in net.modules():
        if isinstance(m, nn.Conv1d):
            fan_in = m.in_channels * m.kernel_size[0]
        elif isinstance(m, nn.ConvTranspose1d):
            fan_in = m.out_channels * m.kernel_size[0]
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
            continue
        else:
            continue
        bound = 1.0 / math.sqrt(fan_in)
        m.weight.uniform_(-bound * math.sqrt(3), bound * math.sqrt(3),
                          generator=generator)
        m.bias.uniform_(-bound, bound, generator=generator)


class SEANetEncoder(nn.Module):
    """model: [SConv1d, (resblock, ELU, stride-ratio SConv1d) per ratio in
    reversed(ratios), SLSTM, ELU, SConv1d] — the encodec package's layer
    indices (0, then 1-12, 13 the LSTM, 15 the final conv)."""

    def __init__(self, *, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, ratios: Sequence[int] = (8, 5, 4, 2),
                 kernel: int = 7, last_kernel: int = 7, res_kernel: int = 3,
                 lstm_layers: int = 2, compress: int = 2):
        super().__init__()
        self.ratios = tuple(reversed(ratios))
        layers = [SConv1d(channels, n_filters, kernel)]
        mult = 1
        for ratio in self.ratios:
            layers += [SEANetResnetBlock(mult * n_filters, compress,
                                         res_kernel),
                       nn.ELU(),
                       SConv1d(mult * n_filters, mult * 2 * n_filters,
                               ratio * 2, stride=ratio)]
            mult *= 2
        layers += [SLSTM(mult * n_filters, lstm_layers), nn.ELU(),
                   SConv1d(mult * n_filters, dimension, last_kernel)]
        self.model = nn.ModuleList(layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        seeded_init(self, generator)

    def forward(self, x, causal=True, pad_mode="reflect"):
        """x: (B, channels, T) waveform -> (B, dimension, ceil(T / hop))."""
        m = self.model
        y = m[0](x, causal, pad_mode)
        for i in range(len(self.ratios)):
            y = m[1 + 3 * i](y, causal, pad_mode)
            y = m[3 + 3 * i](F.elu(y), causal, pad_mode)
        y = m[-3](y)
        return m[-1](F.elu(y), causal, pad_mode)


def seanet_encoder_apply(encoder: SEANetEncoder, x: torch.Tensor, *,
                         causal: bool = True,
                         pad_mode: str = "reflect") -> torch.Tensor:
    """x: (B, T, channels) -> (B, ceil(T / hop), dimension), the JAX
    layout."""
    return encoder(x.transpose(1, 2), causal, pad_mode).transpose(1, 2)


class SEANetDecoder(nn.Module):
    """model: [SConv1d, SLSTM, (ELU, SConvTranspose1d, resblock) per
    ratio, ELU, SConv1d] — the encodec package's layer indices."""

    def __init__(self, *, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, ratios: Sequence[int] = (8, 5, 4, 2),
                 kernel: int = 7, last_kernel: int = 7, res_kernel: int = 3,
                 lstm_layers: int = 2, compress: int = 2):
        super().__init__()
        mult = int(2 ** len(ratios))
        layers = [SConv1d(dimension, mult * n_filters, kernel),
                  SLSTM(mult * n_filters, lstm_layers)]
        for ratio in ratios:
            layers += [nn.ELU(),
                       SConvTranspose1d(mult * n_filters,
                                        mult * n_filters // 2, ratio * 2,
                                        stride=ratio),
                       SEANetResnetBlock(mult * n_filters // 2, compress,
                                         res_kernel)]
            mult //= 2
        layers += [nn.ELU(), SConv1d(n_filters, channels, last_kernel)]
        self.model = nn.ModuleList(layers)
        self.num_ratios = len(ratios)

    def reset_parameters(self, generator: torch.Generator) -> None:
        seeded_init(self, generator)

    def forward(self, z, causal=True, pad_mode="reflect"):
        """z: (B, C, T) latents -> (B, channels, T * hop)."""
        m = self.model
        y = m[0](z, causal, pad_mode)
        y = m[1](y)
        for i in range(self.num_ratios):
            y = m[3 + 3 * i](F.elu(y), causal)
            y = m[4 + 3 * i](y, causal, pad_mode)
        return m[-1](F.elu(y), causal, pad_mode)


def seanet_decoder_apply(decoder: SEANetDecoder, z: torch.Tensor, *,
                         causal: bool = True,
                         pad_mode: str = "reflect") -> torch.Tensor:
    """z: (B, T, dimension) -> (B, T * hop, channels), the JAX layout."""
    return decoder(z.transpose(1, 2), causal, pad_mode).transpose(1, 2)
