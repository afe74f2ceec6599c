"""Plain EnCodec 24 kHz (causal SEANet encoder and decoder, residual
vector quantization), float32, one waveform at a time.

It follows the ``encodec`` package (facebookresearch/encodec,
``encodec/modules/seanet.py``, ``conv.py``, ``lstm.py``,
``quantization/core_vq.py``) with weight norm folded into plain weights,
under the package's parameter names. The LSTM is written out gate by
gate. Every product goes through a ``Precision`` (``precision.py``), so
the same code gives the reference and its lower-precision controls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision


def encoder_layout(cfg: Dict) -> List[Tuple]:
    """The encoder's layers as (kind, index, cin, cout, kernel, stride):
    a first conv, then per ratio (reversed) a residual block and a
    strided conv, the LSTM, a last conv (the package's indices)."""
    nf, out = cfg["n_filters"], []
    out.append(("conv", 0, 1, nf, 7, 1))
    mult = 1
    for i, ratio in enumerate(reversed(cfg["ratios"])):
        out.append(("res", 1 + 3 * i, mult * nf, mult * nf, 3, 1))
        out.append(("conv", 3 + 3 * i, mult * nf, 2 * mult * nf, 2 * ratio,
                    ratio))
        mult *= 2
    n = 3 * len(cfg["ratios"]) + 1
    out.append(("lstm", n, mult * nf, mult * nf, 0, 1))
    out.append(("conv", n + 2, mult * nf, cfg["dimension"], 7, 1))
    return out


def decoder_layout(cfg: Dict) -> List[Tuple]:
    nf, out = cfg["n_filters"], []
    mult = 2 ** len(cfg["ratios"])
    out.append(("conv", 0, cfg["dimension"], mult * nf, 7, 1))
    out.append(("lstm", 1, mult * nf, mult * nf, 0, 1))
    for i, ratio in enumerate(cfg["ratios"]):
        out.append(("convtr", 3 + 3 * i, mult * nf, mult * nf // 2,
                    2 * ratio, ratio))
        out.append(("res", 4 + 3 * i, mult * nf // 2, mult * nf // 2, 3, 1))
        mult //= 2
    n = 3 * len(cfg["ratios"]) + 2
    out.append(("conv", n + 1, nf, 1, 7, 1))
    return out


def parameter_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every tensor the codec holds."""
    shapes = {}
    for side, layout in (("encoder", encoder_layout(cfg)),
                         ("decoder", decoder_layout(cfg))):
        for kind, i, cin, cout, k, _ in layout:
            p = f"{side}.model.{i}"
            if kind == "conv":
                shapes[f"{p}.conv.conv.weight"] = (cout, cin, k)
                shapes[f"{p}.conv.conv.bias"] = (cout,)
            elif kind == "convtr":
                shapes[f"{p}.convtr.convtr.weight"] = (cin, cout, k)
                shapes[f"{p}.convtr.convtr.bias"] = (cout,)
            elif kind == "res":
                h = cin // 2
                for sub, (a, b, kk) in (("block.1", (cin, h, 3)),
                                        ("block.3", (h, cin, 1)),
                                        ("shortcut", (cin, cin, 1))):
                    shapes[f"{p}.{sub}.conv.conv.weight"] = (b, a, kk)
                    shapes[f"{p}.{sub}.conv.conv.bias"] = (b,)
            else:
                for layer in range(cfg["lstm_layers"]):
                    for w, shape in (("weight_ih", (4 * cout, cin)),
                                     ("weight_hh", (4 * cout, cout)),
                                     ("bias_ih", (4 * cout,)),
                                     ("bias_hh", (4 * cout,))):
                        shapes[f"{p}.lstm.{w}_l{layer}"] = shape
    for q in range(cfg["num_quantizers"]):
        shapes[f"quantizer.vq.layers.{q}._codebook.embed"] = (
            cfg["bins"], cfg["dimension"])
    return shapes


def _pad_reflect(x, left: int, right: int):
    """Reflect padding with the package's guard for inputs no longer
    than the padding (zeros appended first, removed after)."""
    T = x.shape[-1]
    m = max(left, right)
    extra = m - T + 1 if m >= T else 0
    if extra:
        x = F.pad(x, (0, extra))
    out = F.pad(x, (left, right), mode="reflect")
    return out[..., : out.shape[-1] - extra] if extra else out


class Codec:
    """EnCodec over the tensors ``sd`` (the names of
    ``parameter_shapes``), computing its products in ``prec``."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 prec: Precision = Precision()):
        self.cfg, self.sd, self.p = cfg, sd, prec

    def _w(self, name):
        return self.sd[name].float()

    def _conv(self, prefix, x, stride: int = 1):
        """Causal streaming conv: left pad k - stride (reflect), right pad
        to a whole last frame."""
        w, b = self._w(prefix + ".conv.conv.weight"), self._w(
            prefix + ".conv.conv.bias")
        k = w.shape[-1]
        pad = k - stride
        n_frames = (x.shape[-1] - k + pad) / stride + 1
        ideal = (math.ceil(n_frames) - 1) * stride + (k - pad)
        x = _pad_reflect(x, pad, max(ideal - x.shape[-1], 0))
        wq = self.p(w.reshape(w.shape[0], -1)).reshape(w.shape)
        return F.conv1d(self.p(x), wq, b, stride=stride)

    def _convtr(self, prefix, x, stride: int):
        w, b = self._w(prefix + ".convtr.convtr.weight"), self._w(
            prefix + ".convtr.convtr.bias")
        wq = self.p(w.reshape(w.shape[0], -1)).reshape(w.shape)
        y = F.conv_transpose1d(self.p(x), wq, b, stride=stride)
        return y[..., : y.shape[-1] - (w.shape[-1] - stride)]

    def _res(self, prefix, x):
        y = self._conv(prefix + ".block.1", F.elu(x))
        y = self._conv(prefix + ".block.3", F.elu(y))
        return self._conv(prefix + ".shortcut", x) + y

    def _lstm(self, prefix, x):
        """x (B, C, T) -> LSTM over T (gates i, f, g, o) plus x."""
        h_in = x.permute(2, 0, 1)                      # (T, B, C)
        seq = h_in
        for layer in range(self.cfg["lstm_layers"]):
            wi = self._w(f"{prefix}.lstm.weight_ih_l{layer}")
            wh = self._w(f"{prefix}.lstm.weight_hh_l{layer}")
            bias = (self._w(f"{prefix}.lstm.bias_ih_l{layer}")
                    + self._w(f"{prefix}.lstm.bias_hh_l{layer}"))
            H = wh.shape[1]
            xs = self.p.linear(seq, wi) + bias         # (T, B, 4H)
            whq = self.p(wh)
            h = seq.new_zeros(seq.shape[1], H)
            c = seq.new_zeros(seq.shape[1], H)
            outs = []
            for t in range(seq.shape[0]):
                gates = xs[t] + self.p(h) @ whq.T
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(h)
            seq = torch.stack(outs)
        return (seq + h_in).permute(1, 2, 0)

    @torch.no_grad()
    def encode(self, wav: torch.Tensor, n_q: int) -> torch.Tensor:
        """wav (T,) float32 -> codes (ceil(T / hop), n_q) int64."""
        z = self._encoder(wav.float()[None, None, :])[0].T      # (F, D)
        residual, codes = z, []
        for q in range(n_q):
            cb = self._w(f"quantizer.vq.layers.{q}._codebook.embed")
            dist = -((residual * residual).sum(-1, keepdim=True)
                     - 2.0 * self.p.linear(residual, cb)
                     + (cb * cb).sum(-1)[None, :])
            idx = dist.argmax(dim=-1)
            residual = residual - cb[idx]
            codes.append(idx)
        return torch.stack(codes, dim=-1)

    def _encoder(self, x):
        """The encoder: convs, residual blocks and strided convs, each
        conv after the first taking ELU of its input, as the package's
        ``nn.Sequential`` orders them."""
        layout = encoder_layout(self.cfg)
        for kind, i, _, _, _, stride in layout:
            p = f"encoder.model.{i}"
            if kind == "res":
                x = self._res(p, x)
            elif kind == "lstm":
                x = self._lstm(p, x)
            elif i == 0:
                x = self._conv(p, x, stride)
            else:
                x = self._conv(p, F.elu(x), stride)
        return x

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (F, n_q) -> wav (F * hop,) float32."""
        z = 0.0
        for q in range(codes.shape[-1]):
            z = z + self._w(f"quantizer.vq.layers.{q}._codebook.embed")[
                codes[:, q].long()]
        x = z.T[None]                                           # (1, D, F)
        layout = decoder_layout(self.cfg)
        for kind, i, _, _, _, stride in layout:
            p = f"decoder.model.{i}"
            if kind == "convtr":
                x = self._convtr(p, F.elu(x), stride)
            elif kind == "res":
                x = self._res(p, x)
            elif kind == "lstm":
                x = self._lstm(p, x)
            elif i == 0:
                x = self._conv(p, x, stride)
            else:
                x = self._conv(p, F.elu(x), stride)
        return x[0, 0]
