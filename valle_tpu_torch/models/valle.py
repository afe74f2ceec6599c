"""VALL-E configuration and parameter module.

Mirror of ``valle_tpu/models/valle.py:47-118,192,229``. ``VALLE`` owns the
AR and NAR parameters under the upstream reference's ``state_dict`` names
(the names ``valle_tpu/utils/checkpoint.py:189 export_torch_state_dict``
emits), including the NAR prediction heads tied to audio embeddings
2..Q-1. The training forward waits for the training port; inference is
``models/inference.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..modules.embedding import (SinePositionalEmbedding, TokenEmbedding,
                                 sine_positional_table)
from ..modules.transformer import TransformerEncoder, _uniform_linear
from .macros import NUM_AUDIO_TOKENS, NUM_TEXT_TOKENS


@dataclass(frozen=True)
class ValleConfig:
    model_name: str = "valle"            # "valle" (GPT-style) | "vallf"
    d_model: int = 1024
    nhead: int = 16
    num_layers: int = 12
    norm_first: bool = True
    add_prenet: bool = False
    prefix_mode: int = 0                  # 0 | 1 | 2 | 4
    share_embedding: bool = True
    nar_scale_factor: float = 1.0
    prepend_bos: bool = False
    num_quantizers: int = 8
    num_text_tokens: int = NUM_TEXT_TOKENS
    num_audio_tokens: int = NUM_AUDIO_TOKENS
    dropout: float = 0.1
    activation: str = "relu"
    max_len: int = 4096                   # PE table length
    max_prefix_len: int = 225             # 3 s at 75 Hz
    remat: str = "full"
    attn_score_bf16: bool = False
    attn_impl: str = "einsum"

    @property
    def nar_d_model(self) -> int:
        return int(self.d_model * self.nar_scale_factor)

    @property
    def nar_nhead(self) -> int:
        return int(self.nhead * self.nar_scale_factor)

    @property
    def nar_num_layers(self) -> int:
        return int(self.num_layers * self.nar_scale_factor)

    @property
    def eos_id(self) -> int:
        return self.num_audio_tokens

    @property
    def bos_id(self) -> int:
        return self.num_audio_tokens + 1

    @property
    def ar_audio_vocab(self) -> int:
        # EOS row always; BOS row only when prepend_bos
        return self.num_audio_tokens + 1 + int(self.prepend_bos)


def pe_table(cfg: ValleConfig, d: int, device=None) -> torch.Tensor:
    return sine_positional_table(cfg.max_len, d, device=device)


class VALLE(nn.Module):
    """AR + NAR parameters of VALL-E (decoder-only, pre-norm).

    ``generator`` seeds the init (on the generator's device); without one
    the parameters are left as PyTorch creates them, e.g. for a
    ``load_state_dict`` right after.
    """

    def __init__(self, cfg: ValleConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.model_name != "valle":
            raise NotImplementedError(
                "VALL-F (the cross-attention decoder) is not ported yet "
                "(ROADMAP A13)")
        if cfg.add_prenet:
            raise NotImplementedError(
                "prenets are not ported yet (ROADMAP A13/A14)")
        if not cfg.norm_first:
            raise NotImplementedError(
                "post-norm stacks are not ported yet (ROADMAP A13/A14)")
        self.cfg = cfg
        d, nd, V, Q = (cfg.d_model, cfg.nar_d_model, cfg.num_audio_tokens,
                       cfg.num_quantizers)
        self.ar_text_embedding = TokenEmbedding(d, cfg.num_text_tokens)
        self.ar_audio_embedding = TokenEmbedding(d, cfg.ar_audio_vocab)
        self.ar_text_position = SinePositionalEmbedding(alpha=True)
        self.ar_audio_position = SinePositionalEmbedding(alpha=True)
        self.ar_decoder = TransformerEncoder(cfg.num_layers, d, cfg.nhead,
                                             4 * d, adaptive=False)
        self.ar_predict_layer = nn.Linear(d, V + 1, bias=False)
        if Q > 1:
            self.nar_text_embedding = TokenEmbedding(nd, cfg.num_text_tokens)
            # slot 0 keeps a row for EOS/PAD (V+1 tokens); 1..Q-1 have V
            self.nar_audio_embeddings = nn.ModuleList(
                [TokenEmbedding(nd, V + 1)]
                + [TokenEmbedding(nd, V) for _ in range(Q - 1)])
            self.nar_text_position = SinePositionalEmbedding(alpha=False)
            self.nar_audio_position = SinePositionalEmbedding(alpha=False)
            self.nar_decoder = TransformerEncoder(
                cfg.nar_num_layers, nd, cfg.nar_nhead, 4 * nd, adaptive=True)
            self.nar_predict_layers = nn.ModuleList(
                nn.Linear(nd, V, bias=False) for _ in range(Q - 1))
            if cfg.share_embedding:
                # head j (0..Q-3) is tied to audio embedding j+2
                for j in range(Q - 2):
                    self.nar_predict_layers[j].weight = (
                        self.nar_audio_embeddings[j + 2]
                        .word_embeddings.weight)
            self.nar_stage_embeddings = nn.ModuleList(
                TokenEmbedding(nd, 1) for _ in range(Q - 1))
        if generator is not None:
            self.to(generator.device)
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """N(0, 1) embeddings, unit alphas, the stacks' own init, torch-
        Linear bounds for the untied prediction heads."""
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(generator=gen)
            elif isinstance(m, SinePositionalEmbedding):
                m.alpha.fill_(1.0)
            elif isinstance(m, TransformerEncoder):
                m.reset_parameters(gen)
        _uniform_linear(self.ar_predict_layer, gen)
        if self.cfg.num_quantizers > 1:
            first = (self.cfg.num_quantizers - 2
                     if self.cfg.share_embedding else 0)
            for lin in list(self.nar_predict_layers)[first:]:
                _uniform_linear(lin, gen)


def nar_predict_weights(model: VALLE) -> torch.Tensor:
    """Stacked NAR output heads (Q-1, V, nd) in PyTorch's (out, in) layout
    (the JAX package stacks them as (Q-1, nd, V))."""
    return torch.stack([lin.weight for lin in model.nar_predict_layers])
