"""The Transformer TTS on mel spectrograms (the reference's debug model).

Mirror of ``valle_tpu/models/transformer.py`` (arXiv:1809.08895): a text
encoder and an autoregressive mel decoder with cross-attention, MSE (sum)
plus 100 x the weighted stop-token BCE, the optional prenets, and the
``--scaling-xformers`` variant that makes every projection a ScaledLinear,
the activation a BalancedDoubleSwish and the norms IdentityNorm /
BalancedBasicNorm (``modules/scaling.py``).

Parameter names are the upstream reference's (``models/transformer.py
:41-171``, PyTorch's ``nn.Transformer*`` containers): ``text_embedding.
word_embeddings.weight``; ``encoder_prenet.{1,5,9}`` convs, ``.{2,6,10}``
BatchNorms and ``.14`` Linear; ``decoder_prenet`` a Linear or, with
prenets, Linears at ``.{0,3,6}``; ``encoder_position.alpha`` /
``decoder_position.alpha`` (fixed at 1, not trained); ``encoder.layers.
{i}`` with ``self_attn.{in_proj_weight, in_proj_bias, out_proj}``,
``linear1``, ``linear2``, ``norm1``, ``norm2``; ``decoder.layers.{i}`` adds
``multihead_attn`` and ``norm3``; ``encoder.norm`` / ``decoder.norm`` (pre-
norm only); ``predict_layer``; ``stop_layer``. The scaling variant keeps
these names: an IdentityNorm slot has no parameter, a BalancedBasicNorm
holds ``norm.eps`` (the log of eps), and the attention keeps
``in_proj_weight`` / ``in_proj_bias`` without the reference fork's second
name for the same tensors (``in_proj_linear``).

Attention goes through ``modules/transformer.py`` (``mha_self``,
``mha_kv``, ``mha_cross``, ``attend``) as VALL-E's does: without dropout
and with fp32 scores it is ``ops/attention.py fused_attention``, so under
VALLE_TPU_FLASH_ATTENTION=1 on the card every attention with more than
one query and at least 128 keys launches the flash kernel B6.

Random draws: one CPU ``torch.Generator`` gives the forward's six seeds;
every dropout, balancer gate and BasicNorm clamp of a layer derives from
its own seed (``modules/scaling.py draw_uniforms``), as the JAX layer
splits its key ten ways. Compute dtype: the text embedding and both
stacks run in ``compute_dtype`` (the decoder prenet's output is cast to
it); the output heads run in fp32 on the fp32-cast hidden states, as JAX
promotes them.

Inference is a KV-cache greedy loop over the decoder on the host (one
device read a frame for the stop rule), with the cross-attention's K/V
made once per layer. It applies the encoder prenet before the positions,
as the forward and the reference do; JAX's ``transformer_tts_inference``
leaves it out (ROADMAP C13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..modules import scaling as sc
from ..modules.embedding import (SinePositionalEmbedding, TokenEmbedding,
                                 apply_sine_positional, dropout,
                                 sine_positional_table, token_embedding)
from ..modules.prenet import (AudioPrenet, TextPrenet, audio_prenet,
                              text_prenet)
from ..modules.transformer import (MultiheadAttention, _uniform_linear,
                                   attend, layer_norm, linear, merge_heads,
                                   mha_cross, mha_kv, mha_self, split_qkv)
from ..ops import masks as M
from ..ops.philox import fold_seed
from ..parallel.mesh import ranks_share
from .macros import NUM_MEL_BINS, NUM_TEXT_TOKENS
from .valle import _draw_seeds, _global

STOP_WEIGHT = 100.0       # the stop loss's weight in the total
FINAL_NORM_SEED = 999     # JAX folds the stack's key with 999 for it


@dataclass(frozen=True)
class TransformerTtsConfig:
    d_model: int = 1024
    nhead: int = 16
    num_layers: int = 12
    norm_first: bool = True
    add_prenet: bool = False
    scaling_xformers: bool = False
    num_mel_bins: int = NUM_MEL_BINS
    num_text_tokens: int = NUM_TEXT_TOKENS
    dropout: float = 0.1
    max_len: int = 4096


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------


def _scaled_attention(d: int, nhead: int) -> MultiheadAttention:
    """MultiheadAttention with a ScaledLinear(0.01) out-projection
    (reference models/transformer.py:123-126)."""
    attn = MultiheadAttention(d, nhead)
    attn.out_proj = sc.ScaledLinear(d, d, initial_scale=0.01)
    return attn


class TtsLayer(nn.Module):
    """One encoder layer, or with ``decoder`` one decoder layer (its
    cross-attention ``multihead_attn`` and ``norm3``). Plain: LayerNorms,
    Linears. Scaling: ScaledLinears (0.01 for ``linear2``), IdentityNorm
    (None) for norm1 (and the decoder's norm2), BalancedBasicNorm for the
    FFN's norm (the encoder's norm2, the decoder's norm3)."""

    def __init__(self, cfg: TransformerTtsConfig, decoder: bool):
        super().__init__()
        d, f, H = cfg.d_model, 4 * cfg.d_model, cfg.nhead
        if cfg.scaling_xformers:
            self.self_attn = _scaled_attention(d, H)
            self.linear1 = sc.ScaledLinear(d, f)
            self.linear2 = sc.ScaledLinear(f, d, initial_scale=0.01)
            self.norm1 = None
            if decoder:
                self.multihead_attn = _scaled_attention(d, H)
                self.norm2 = None
                self.norm3 = sc.BalancedBasicNorm()
            else:
                self.norm2 = sc.BalancedBasicNorm()
        else:
            self.self_attn = MultiheadAttention(d, H)
            self.linear1 = nn.Linear(d, f)
            self.linear2 = nn.Linear(f, d)
            self.norm1 = nn.LayerNorm(d)
            self.norm2 = nn.LayerNorm(d)
            if decoder:
                self.multihead_attn = MultiheadAttention(d, H)
                self.norm3 = nn.LayerNorm(d)


class TtsStack(nn.Module):
    """``layers`` and, pre-norm only, the final ``norm`` (a LayerNorm, or a
    BalancedBasicNorm in the scaling variant)."""

    def __init__(self, cfg: TransformerTtsConfig, decoder: bool):
        super().__init__()
        self.layers = nn.ModuleList(TtsLayer(cfg, decoder)
                                    for _ in range(cfg.num_layers))
        self.norm = None
        if cfg.norm_first:
            self.norm = (sc.BalancedBasicNorm() if cfg.scaling_xformers
                         else nn.LayerNorm(cfg.d_model))


class TransformerTtsModel(nn.Module):
    """The Transformer TTS's parameters under the reference's names.

    ``generator`` seeds the init (on the generator's device); without one
    the parameters are left as PyTorch creates them, e.g. for a
    ``load_state_dict`` right after."""

    def __init__(self, cfg: TransformerTtsConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.add_prenet and cfg.scaling_xformers:
            raise ValueError("--add-prenet and --scaling-xformers do not go "
                             "together (reference transformer.py:97)")
        self.cfg = cfg
        d, Mb = cfg.d_model, cfg.num_mel_bins
        lin = sc.ScaledLinear if cfg.scaling_xformers else nn.Linear
        self.text_embedding = TokenEmbedding(d, cfg.num_text_tokens)
        if cfg.add_prenet:
            self.encoder_prenet = TextPrenet(d)
            self.decoder_prenet = AudioPrenet(d, d_in=Mb)
        else:
            self.decoder_prenet = lin(Mb, d)
        self.encoder_position = SinePositionalEmbedding(alpha=False)
        self.decoder_position = SinePositionalEmbedding(alpha=False)
        self.encoder = TtsStack(cfg, decoder=False)
        self.decoder = TtsStack(cfg, decoder=True)
        self.predict_layer = lin(d, Mb)
        self.stop_layer = nn.Linear(d, 1)
        if generator is not None:
            self.to(generator.device)
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """JAX ``init_transformer_tts``'s distributions: N(0, 1) text
        embedding; xavier-uniform attention in-projections with zero
        biases; torch-Linear bounds for the plain Linears and zero
        out-projection biases; ScaledLinears' own init; unit LayerNorms,
        BasicNorms at log(0.25); the prenets' own init."""
        self.text_embedding.word_embeddings.weight.normal_(generator=gen)
        for m in self.modules():
            if isinstance(m, SinePositionalEmbedding):
                m.alpha.fill_(1.0)
            elif isinstance(m, (TextPrenet, AudioPrenet)):
                m.reset_parameters(gen)
            elif isinstance(m, sc.BasicNorm):
                m.reset_parameters()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in self.modules():
            if isinstance(m, MultiheadAttention):
                d = m.in_proj_weight.shape[1]
                a = (6.0 / (d + 3 * d)) ** 0.5
                m.in_proj_weight.uniform_(-a, a, generator=gen)
                m.in_proj_bias.zero_()
        prenet = {id(m) for p in self.modules()
                  if isinstance(p, (TextPrenet, AudioPrenet))
                  for m in p.modules()}
        for m in self.modules():
            if isinstance(m, sc.ScaledLinear):
                m.reset_parameters(gen)
            elif isinstance(m, nn.Linear) and id(m) not in prenet:
                _uniform_linear(m, gen)
        for m in self.modules():
            if isinstance(m, MultiheadAttention) and not isinstance(
                    m.out_proj, sc.ScaledLinear):
                m.out_proj.bias.zero_()

    def forward(self, batch, **kw):
        return transformer_tts_forward(self, batch, **kw)

    def inference(self, text, text_lens, **kw):
        return transformer_tts_inference(self, text, text_lens, **kw)


# ---------------------------------------------------------------------------
# Layer application (both norm and activation variants)
# ---------------------------------------------------------------------------


def _apply_norm(norm, x, seed: Optional[int] = None, training=False):
    """IdentityNorm (None), LayerNorm, or BalancedBasicNorm with its gate
    (probability 0.1) and log-eps clamp (0.25) drawn from ``seed`` in
    training."""
    if norm is None:
        return x
    if isinstance(norm, sc.BalancedBasicNorm):
        u = sc.draw_uniforms(seed, 2) if training else None
        return sc.balanced_basic_norm(
            norm, x, gate=None if u is None else float(u[0] < 0.1),
            clamp=None if u is None else u[1] < 0.25, training=training)
    return layer_norm(norm, x)


def _activation(cfg, x, seed: Optional[int] = None, training=False):
    if cfg.scaling_xformers:
        u = sc.draw_uniforms(seed, 1) if training else None
        return sc.balanced_double_swish(
            x, None if u is None else float(u[0] < 0.25), channel_dim=-1,
            max_abs=10.0, min_prob=0.25, training=training)
    return F.relu(x)


def _ffn(cfg, layer, h, sd, training, drop, dtype):
    h = linear(h, layer.linear1.weight, layer.linear1.bias, dtype)
    h = dropout(_activation(cfg, h, sd[7], training), drop, sd[8])
    h = linear(h, layer.linear2.weight, layer.linear2.bias, dtype)
    # the reference's residual dropout after linear2 (dropout2/dropout3)
    return dropout(h, drop, sd[9])


def _layer_apply(cfg, layer, x, bias, memory=None, cross_bias=None, *,
                 seed: Optional[int] = None, training=False, dtype=None):
    """One layer (JAX ``_layer_apply``): pre-norm ``x + f(norm(x))`` or
    post-norm ``norm(x + f(x))`` for the self-attention, the
    cross-attention over ``memory`` (decoder layers) and the FFN. Its ten
    draws (norms, attention dropout, branch dropouts, activation gate)
    come from seeds folded from ``seed``."""
    sd = [None] * 10 if seed is None else [fold_seed(seed, i)
                                           for i in range(10)]
    drop = cfg.dropout if training else 0.0
    nf = cfg.norm_first

    def residual(norm, x, slot, f):
        if nf:
            return x + f(_apply_norm(norm, x, sd[slot], training))
        return _apply_norm(norm, x + f(x), sd[slot], training)

    x = residual(layer.norm1, x, 0, lambda h: dropout(mha_self(
        layer.self_attn, h, bias, dtype=dtype, dropout_rate=drop,
        seed=sd[1]), drop, sd[2]))
    if memory is not None:
        mk, mv = mha_kv(layer.multihead_attn, memory, dtype)
        x = residual(layer.norm2, x, 3, lambda h: dropout(mha_cross(
            layer.multihead_attn, h, mk, mv, cross_bias, dtype=dtype,
            dropout_rate=drop, seed=sd[4]), drop, sd[5]))
        ffn_norm = layer.norm3
    else:
        ffn_norm = layer.norm2
    return residual(ffn_norm, x, 6,
                    lambda h: _ffn(cfg, layer, h, sd, training, drop, dtype))


def _stack_apply(cfg, stack: TtsStack, x, bias, memory=None, cross_bias=None,
                 *, seed: Optional[int] = None, training=False, dtype=None):
    for i, layer in enumerate(stack.layers):
        x = _layer_apply(cfg, layer, x, bias, memory, cross_bias,
                         seed=None if seed is None else fold_seed(seed, i),
                         training=training, dtype=dtype)
    if stack.norm is not None:
        x = _apply_norm(stack.norm, x, None if seed is None else fold_seed(
            seed, FINAL_NORM_SEED), training)
    return x


def _decoder_prenet(model, y, *, seed: Optional[int], training: bool):
    """Mel frames (..., num_mel_bins) -> (..., d) in y's dtype: the prenet
    (dropout 0.5 after its first two Linears in training), or one
    Linear."""
    p = model.decoder_prenet
    if isinstance(p, AudioPrenet):
        return audio_prenet(p, y, training=training, seed=seed, rate=0.5)
    return linear(y, p.weight, p.bias, y.dtype)


def _heads_fp32(model, h):
    """The mel and stop heads in fp32 on the hidden states."""
    hf = h.float()
    predict = linear(hf, model.predict_layer.weight.float(),
                     model.predict_layer.bias.float())
    stop = linear(hf, model.stop_layer.weight.float(),
                  model.stop_layer.bias.float())[..., 0]
    return predict, stop


def _encode(model, text, x_lens, *, seeds, training, dtype, reduce_stats):
    """Text -> encoder output (B, S, d): embedding, prenet, positions
    (dropout 0.1), the encoder stack."""
    cfg = model.cfg
    pe = sine_positional_table(cfg.max_len, cfg.d_model, device=text.device)
    x = token_embedding(model.text_embedding.word_embeddings.weight, text,
                        dtype)
    if cfg.add_prenet:
        x = text_prenet(model.encoder_prenet, x, training=training,
                        seed=seeds[0], reduce_stats=reduce_stats)
    x = apply_sine_positional(model.encoder_position.alpha, x, pe,
                              dropout_rate=0.1, seed=seeds[1])
    return _stack_apply(cfg, model.encoder, x,
                        M.key_padding_bias(x_lens, text.shape[1]),
                        seed=seeds[2], training=training, dtype=dtype), pe


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def transformer_tts_forward(model: TransformerTtsModel,
                            batch: Dict[str, torch.Tensor], *,
                            train_stage: int = 0,
                            generator: Optional[torch.Generator] = None,
                            deterministic: bool = False,
                            compute_dtype=torch.float32,
                            collect_outputs: bool = False
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSE (sum) + 100 x the weighted stop BCE (reference
    transformer.py:222-318): (loss, metrics).

    batch: ``text`` (B, S), ``text_lens``, ``audio`` (B, T, num_mel_bins)
    float features, ``audio_lens``. ``train_stage`` is accepted and
    ignored (one model, no stages). Metrics: ``stop_loss``,
    ``stop_accuracy`` (over every frame of the batch, padding included),
    ``frames``; ``collect_outputs`` adds ``encoder_out`` and ``predict``
    (for ``--visualize``). A training forward (``deterministic`` False)
    moves the prenet's running statistics, as JAX returns its new state.
    On a rank's rows (``global_*`` keys) the accuracy is the rank's share
    of the global microbatch's."""
    del train_stage
    cfg = model.cfg
    training = not deterministic
    seeds = _draw_seeds(generator, training, batch, 6)
    text = batch["text"].long()
    x_lens = batch["text_lens"].long()
    y = batch["audio"].float()
    y_lens = batch["audio_lens"].long()
    B, T = y.shape[0], y.shape[1]
    dev = text.device

    x, pe = _encode(model, text, x_lens, seeds=seeds, training=training,
                    dtype=compute_dtype, reduce_stats=ranks_share(batch))

    y_mask = torch.arange(T, device=dev)[None, :] >= y_lens[:, None]
    y_mask_f = y_mask.float()
    targets = y * (1.0 - y_mask_f)[..., None]
    # shift right with a zero frame (reference transformer.py:274-279)
    y_in = F.pad(targets, (0, 0, 1, 0))[:, :-1]
    y_emb = _decoder_prenet(model, y_in.to(compute_dtype),
                            seed=None if seeds[3] is None
                            else fold_seed(seeds[3], 3), training=training)
    y_pos = apply_sine_positional(model.decoder_position.alpha, y_emb, pe,
                                  dropout_rate=0.1, seed=seeds[3])
    y_dec = _stack_apply(cfg, model.decoder, y_pos, M.causal_bias(T, dev),
                         memory=x,
                         cross_bias=M.key_padding_bias(x_lens, x.shape[1]),
                         seed=seeds[4], training=training,
                         dtype=compute_dtype)

    predict, logits = _heads_fp32(model, y_dec)
    mse = ((predict - targets) ** 2).sum()
    weight = 1.0 + y_mask_f * 4.0
    stop_loss = (weight * (torch.clamp_min(logits, 0) - logits * y_mask_f
                           + torch.log1p(torch.exp(-logits.abs())))).sum()
    hits = ((torch.sigmoid(logits) >= 0.5) == y_mask).float().sum()
    rows = int(_global(batch, "rows", B))
    metrics = {"stop_loss": stop_loss,
               "stop_accuracy": hits / float(rows * T),
               "frames": y_lens.sum().float()}
    if collect_outputs:
        metrics["encoder_out"] = x.float()
        metrics["predict"] = predict
    return mse + STOP_WEIGHT * stop_loss, metrics


@torch.no_grad()
def transformer_visualize_outputs(model: TransformerTtsModel, batch):
    """(encoder output, predicted mel) for the trainer's --visualize."""
    _, m = transformer_tts_forward(model, batch, deterministic=True,
                                   collect_outputs=True)
    return m["encoder_out"], m["predict"]


# ---------------------------------------------------------------------------
# Inference (KV-cache greedy frame loop)
# ---------------------------------------------------------------------------


@torch.no_grad()
def transformer_tts_inference(model: TransformerTtsModel, text, text_lens, *,
                              max_gen_len: int = 1024,
                              compute_dtype=torch.float32):
    """Greedy AR mel generation: (mel (B, max_gen_len, num_mel_bins) fp32,
    lens (B,) int64).

    Each lane stops at its first frame t whose stop logit is > 0 or with
    t > 10 x its text length (reference transformer.py:376-377); ``lens``
    is that t (``max_gen_len`` for a lane that never stops), and the
    frames from it on are zero. The loop ends once every lane has
    stopped. Each frame feeds the previous prediction through the decoder
    prenet, writes the self-attention K/V of every layer at position t
    and attends over positions <= t; the cross-attention K/V are made
    once per layer."""
    cfg = model.cfg
    dtype = compute_dtype
    dev = text.device
    text = text.long()
    x_lens = text_lens.long().to(dev)
    B, S = text.shape
    H, L = cfg.nhead, cfg.num_layers
    dh = cfg.d_model // H
    nf = cfg.norm_first
    memory, pe = _encode(model, text, x_lens, seeds=[None] * 3,
                         training=False, dtype=dtype, reduce_stats=False)
    layers = list(model.decoder.layers)
    mem_kv = [mha_kv(layer.multihead_attn, memory, dtype)
              for layer in layers]
    cross_bias = M.key_padding_bias(x_lens, S)
    cache = torch.zeros(2, L, B, H, max_gen_len + 1, dh, dtype=dtype,
                        device=dev)
    frame = torch.zeros(B, cfg.num_mel_bins, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    mel = torch.zeros(B, max_gen_len, cfg.num_mel_bins, device=dev)
    lens = torch.full((B,), max_gen_len, dtype=torch.long, device=dev)
    alpha = model.decoder_position.alpha.to(dtype)
    sd = [None] * 10

    for t in range(max_gen_len):
        h = _decoder_prenet(model, frame[:, None].to(dtype), seed=None,
                            training=False) + alpha * pe[t].to(dtype)
        for li, layer in enumerate(layers):
            attn = layer.self_attn

            def sa(hin, li=li, attn=attn):
                q, k, v = split_qkv(linear(hin, attn.in_proj_weight,
                                           attn.in_proj_bias, dtype), H)
                cache[0, li, :, :, t] = k[:, :, 0]
                cache[1, li, :, :, t] = v[:, :, 0]
                out = merge_heads(attend(q, cache[0, li, :, :, :t + 1],
                                         cache[1, li, :, :, :t + 1], None))
                return linear(out, attn.out_proj.weight, attn.out_proj.bias,
                              dtype)

            def ca(hin, li=li, layer=layer):
                return mha_cross(layer.multihead_attn, hin, *mem_kv[li],
                                 cross_bias, dtype=dtype)

            for norm, f in ((layer.norm1, sa), (layer.norm2, ca),
                            (layer.norm3, lambda hin, layer=layer: _ffn(
                                cfg, layer, hin, sd, False, 0.0, dtype))):
                h = (h + f(_apply_norm(norm, h)) if nf
                     else _apply_norm(norm, h + f(h)))
        if model.decoder.norm is not None:
            h = _apply_norm(model.decoder.norm, h)
        nxt, stop_logit = _heads_fp32(model, h)
        nxt, stop_logit = nxt[:, 0], stop_logit[:, 0]
        stop = (stop_logit > 0) | (t > x_lens * 10)
        lens = torch.where(stop & ~done, torch.full_like(lens, t), lens)
        done = done | stop
        mel[:, t] = torch.where(done[:, None], torch.zeros_like(nxt), nxt)
        frame = nxt
        if bool(done.all()):
            break
    return mel, lens
