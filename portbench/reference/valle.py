"""Plain VALL-E (decoder-only AR and NAR transformers), float32, one
request at a time, no cache, no padding, no kernel.

It follows the VALL-E paper (arXiv:2301.02111, section 4) as
lifeiteng/vall-e implements it (``valle/models/valle.py`` ``VALLE``,
``valle/modules/transformer.py``), under that repository's parameter
names: pre-norm layers (``x + SA(LN(x))``, ``x + FFN(LN(x))``, ReLU),
a final norm; sinusoidal positions (sin and cos interleaved) scaled by
``alpha``; the AR stack over ``[text; audio]`` with text keys visible to
every query and audio keys causal; the NAR stack bidirectional with its
norms modulated by the stage embedding (AdaLN ``w * LN(x) + b``, ``(w,
b)`` a projection of the stage embedding), the prompt's quantizers all
summed into its embedding (prefix mode 1) and the prediction heads of
stages 0..Q-3 tied to audio embeddings 2..Q-1.

It computes logits teacher-forced over given tokens, which is how the
benchmark judges what a server decoded: ``ar_logits`` gives the logits
that predict each generated first-quantizer token from the text, the
prompt and the tokens before it; ``nar_logits`` those of quantizer
``stage + 1`` from the text, the prompt and quantizers 0..stage. Every
product goes through a ``Precision`` (``precision.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision


def parameter_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every trainable tensor of VALL-E, the tied NAR
    heads included under their own names."""
    d, V, Q, T = (cfg["d_model"], cfg["num_audio_tokens"],
                  cfg["num_quantizers"], cfg["num_text_tokens"])
    shapes = {"ar_text_embedding.word_embeddings.weight": (T, d),
              "ar_audio_embedding.word_embeddings.weight": (V + 1, d),
              "ar_text_position.alpha": (1,),
              "ar_audio_position.alpha": (1,),
              "ar_predict_layer.weight": (V + 1, d),
              "nar_text_embedding.word_embeddings.weight": (T, d),
              "nar_audio_embeddings.0.word_embeddings.weight": (V + 1, d),
              "nar_text_position.alpha": (1,),
              "nar_audio_position.alpha": (1,)}
    for j in range(1, Q):
        shapes[f"nar_audio_embeddings.{j}.word_embeddings.weight"] = (V, d)
    for i in range(Q - 1):
        shapes[f"nar_predict_layers.{i}.weight"] = (V, d)
        shapes[f"nar_stage_embeddings.{i}.word_embeddings.weight"] = (1, d)
    for side, ada in (("ar", False), ("nar", True)):
        norms = [f"{side}_decoder.norm"]
        for li in range(cfg["num_layers"]):
            p = f"{side}_decoder.layers.{li}"
            shapes.update({
                f"{p}.self_attn.in_proj_weight": (3 * d, d),
                f"{p}.self_attn.in_proj_bias": (3 * d,),
                f"{p}.self_attn.out_proj.weight": (d, d),
                f"{p}.self_attn.out_proj.bias": (d,),
                f"{p}.linear1.weight": (4 * d, d),
                f"{p}.linear1.bias": (4 * d,),
                f"{p}.linear2.weight": (d, 4 * d),
                f"{p}.linear2.bias": (d,)})
            norms += [f"{p}.norm1", f"{p}.norm2"]
        for n in norms:
            if ada:
                shapes[f"{n}.project_layer.weight"] = (2 * d, d)
                shapes[f"{n}.project_layer.bias"] = (2 * d,)
                n = n + ".norm"
            shapes[f"{n}.weight"] = (d,)
            shapes[f"{n}.bias"] = (d,)
    return shapes


def tied_heads(cfg: Dict) -> Dict[str, str]:
    """NAR head name -> the audio embedding it shares its weight with."""
    Q = cfg["num_quantizers"]
    return {f"nar_predict_layers.{j}.weight":
            f"nar_audio_embeddings.{j + 2}.word_embeddings.weight"
            for j in range(Q - 2)}


def sine_table(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * -(math.log(10000.0) / d))
    pe = torch.zeros(n, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class Model:
    """VALL-E over the tensors ``sd`` (the names of
    ``parameter_shapes``), computing its products in ``prec``."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 prec: Precision = Precision()):
        self.cfg, self.sd, self.p = cfg, sd, prec
        self.H = cfg["nhead"]

    def w(self, name):
        return self.sd[name].float()

    def _norm(self, prefix, x, cond):
        if cond is None:
            return F.layer_norm(x, x.shape[-1:], self.w(prefix + ".weight"),
                                self.w(prefix + ".bias"), 1e-5)
        wb = self.p.linear(cond, self.w(prefix + ".project_layer.weight"),
                           self.w(prefix + ".project_layer.bias"))
        gain, shift = wb.chunk(2, dim=-1)
        y = F.layer_norm(x, x.shape[-1:], self.w(prefix + ".norm.weight"),
                         self.w(prefix + ".norm.bias"), 1e-5)
        return gain * y + shift

    def _attention(self, prefix, x, visible):
        n, d = x.shape
        qkv = self.p.linear(x, self.w(prefix + ".in_proj_weight"),
                            self.w(prefix + ".in_proj_bias"))
        q, k, v = (t.reshape(n, self.H, d // self.H).transpose(0, 1)
                   for t in qkv.chunk(3, dim=-1))
        s = self.p.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // self.H)
        s = s.masked_fill(~visible, float("-inf"))
        out = self.p.matmul(torch.softmax(s, dim=-1), v)
        out = out.transpose(0, 1).reshape(n, d)
        return self.p.linear(out, self.w(prefix + ".out_proj.weight"),
                             self.w(prefix + ".out_proj.bias"))

    def _stack(self, side, x, visible, cond=None):
        for li in range(self.cfg["num_layers"]):
            p = f"{side}_decoder.layers.{li}"
            x = x + self._attention(p + ".self_attn",
                                    self._norm(p + ".norm1", x, cond),
                                    visible)
            h = self._norm(p + ".norm2", x, cond)
            h = torch.relu(self.p.linear(h, self.w(p + ".linear1.weight"),
                                         self.w(p + ".linear1.bias")))
            x = x + self.p.linear(h, self.w(p + ".linear2.weight"),
                                  self.w(p + ".linear2.bias"))
        return self._norm(f"{side}_decoder.norm", x, cond)

    def _positions(self, side, what, n):
        return (self.w(f"{side}_{what}_position.alpha")
                * sine_table(n, self.cfg["d_model"], self.sd[
                    f"{side}_{what}_position.alpha"].device))

    @torch.no_grad()
    def ar_logits(self, text, prompt_q0, gen_q0) -> torch.Tensor:
        """text (S,) ids with <bos>/<eos>, prompt_q0 (P,), gen_q0 (F,) ->
        (F, V + 1): row t predicts gen_q0[t]."""
        S, P, Fr = text.shape[0], prompt_q0.shape[0], gen_q0.shape[0]
        x = (self.w("ar_text_embedding.word_embeddings.weight")[text]
             + self._positions("ar", "text", S))
        y_ids = torch.cat([prompt_q0, gen_q0[:-1]]).long()
        y = (self.w("ar_audio_embedding.word_embeddings.weight")[y_ids]
             + self._positions("ar", "audio", y_ids.shape[0]))
        n = S + y_ids.shape[0]
        pos = torch.arange(n, device=text.device)
        is_audio = pos >= S
        visible = (~is_audio[None, :]) | (
            is_audio[:, None] & (pos[None, :] <= pos[:, None]))
        h = self._stack("ar", torch.cat([x, y]), visible)
        h = h[S + P - 1: S + P - 1 + Fr]
        return self.p.linear(h, self.w("ar_predict_layer.weight"))

    @torch.no_grad()
    def nar_logits(self, text, prompt, gen, stage: int) -> torch.Tensor:
        """text (S,), prompt (P, Q), gen (F, Q) codes -> (F, V): the logits
        of quantizer ``stage + 1`` from quantizers 0..stage of ``gen``."""
        S, P, Fr = text.shape[0], prompt.shape[0], gen.shape[0]
        emb = [self.w(f"nar_audio_embeddings.{j}.word_embeddings.weight")
               for j in range(self.cfg["num_quantizers"])]
        x = (self.w("nar_text_embedding.word_embeddings.weight")[text]
             + self._positions("nar", "text", S))
        yp = sum(emb[j][prompt[:, j].long()] for j in range(len(emb)))
        yg = sum(emb[j][gen[:, j].long()] for j in range(stage + 1))
        y = torch.cat([yp, yg]) + self._positions("nar", "audio", P + Fr)
        n = S + P + Fr
        visible = torch.ones(n, n, dtype=torch.bool, device=text.device)
        cond = self.w(f"nar_stage_embeddings.{stage}.word_embeddings.weight")
        h = self._stack("nar", torch.cat([x, y]), visible, cond)[-Fr:]
        return self.p.linear(h, self.w(f"nar_predict_layers.{stage}.weight"))
