"""VALL-E / VALL-F configuration, parameter module and training forward.

Mirror of ``valle_tpu/models/valle.py``. ``VALLE`` owns the AR and NAR
parameters under the upstream reference's ``state_dict`` names (the names
``valle_tpu/utils/checkpoint.py:189 export_torch_state_dict`` emits),
including the NAR prediction heads tied to audio embeddings 2..Q-1, the
optional prenets (``modules/prenet.py``) and their BatchNorm statistics
(buffers). ``model_name`` "valle" is decoder-only (text and audio in one
sequence); "vallf" encodes the text as the cross-attention memory of a
decoder stack (JAX ``_vallf_forward``). ``norm_first`` False builds
post-norm stacks without a final norm.
``valle_forward`` is the training forward (AR and NAR losses, top-10
accuracies, prefix modes 0/1/2/4): with prenets, a training forward
(``deterministic`` False) takes the batch's statistics and moves the
running ones once, what JAX returns as ``new_state``; a deterministic one
reads them. ``valle_ar_forward_packed`` and
``valle_nar_forward_packed`` train on sequence-packed rows
(``data/packing.py``); inference is ``models/inference.py``.

Random draws: the JAX forward splits one key eight ways. Here one CPU
``torch.Generator`` gives eight 62-bit seeds on the host; each frontend
dropout and each layer of a stack derives its masks from its own seed,
and the NAR stage and prefix draws are host integers (the reference
draws them on the host too).

Data parallelism: a rank's batch holds its own rows and, under
``global_*`` keys, the statistics of the whole (global) microbatch that
the JAX forward takes over every row (``parallel/mesh.py local_rows``):
the NAR prefix draw and loss scale, mode 2's per-row starts, mode 4's
prompt length, the accuracies' denominators. ``global_rank`` is folded
into the dropout seeds after every draw from the generator, so ranks
share the NAR stage and prefix but not their dropout masks. A batch
without these keys is the whole microbatch; with them, in a job of more
than one rank, the prenets' batch statistics are summed over the ranks
(``parallel/mesh.py ranks_share``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.embedding import (SinePositionalEmbedding, TokenEmbedding,
                                 apply_sine_positional,
                                 apply_sine_positional_gather,
                                 sine_positional_table, token_embedding)
from ..modules.prenet import (AudioPrenet, TextPrenet, audio_prenet,
                              text_prenet)
from ..modules.transformer import (TransformerDecoder, TransformerEncoder,
                                   _uniform_linear, decoder_stack_apply,
                                   encoder_stack_apply)
from ..ops import masks as M
from ..ops.philox import fold_seed
from ..parallel.mesh import ranks_share
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
    """AR + NAR parameters of VALL-E or VALL-F (``cfg.model_name``), pre-
    or post-norm, with or without prenets.

    ``generator`` seeds the init (on the generator's device); without one
    the parameters are left as PyTorch creates them, e.g. for a
    ``load_state_dict`` right after.
    """

    def __init__(self, cfg: ValleConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.model_name not in ("valle", "vallf"):
            raise ValueError(f"unknown model_name {cfg.model_name!r}")
        self.cfg = cfg
        d, nd, V, Q = (cfg.d_model, cfg.nar_d_model, cfg.num_audio_tokens,
                       cfg.num_quantizers)
        stack = (TransformerDecoder if cfg.model_name == "vallf"
                 else TransformerEncoder)
        self.ar_text_embedding = TokenEmbedding(d, cfg.num_text_tokens)
        self.ar_audio_embedding = TokenEmbedding(d, cfg.ar_audio_vocab)
        self.ar_text_position = SinePositionalEmbedding(alpha=True)
        self.ar_audio_position = SinePositionalEmbedding(alpha=True)
        self.ar_decoder = stack(cfg.num_layers, d, cfg.nhead, 4 * d,
                                adaptive=False, norm_first=cfg.norm_first)
        self.ar_predict_layer = nn.Linear(d, V + 1, bias=False)
        if cfg.add_prenet:
            self.ar_text_prenet = TextPrenet(d)
            self.ar_audio_prenet = AudioPrenet(d)
        if Q > 1:
            self.nar_text_embedding = TokenEmbedding(nd, cfg.num_text_tokens)
            # slot 0 keeps a row for EOS/PAD (V+1 tokens); 1..Q-1 have V
            self.nar_audio_embeddings = nn.ModuleList(
                [TokenEmbedding(nd, V + 1)]
                + [TokenEmbedding(nd, V) for _ in range(Q - 1)])
            self.nar_text_position = SinePositionalEmbedding(alpha=False)
            self.nar_audio_position = SinePositionalEmbedding(alpha=False)
            self.nar_decoder = stack(cfg.nar_num_layers, nd, cfg.nar_nhead,
                                     4 * nd, adaptive=True,
                                     norm_first=cfg.norm_first)
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
            if cfg.add_prenet:
                self.nar_text_prenet = TextPrenet(nd)
                self.nar_audio_prenet = AudioPrenet(nd)
        if generator is not None:
            self.to(generator.device)
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """N(0, 1) embeddings, unit alphas, the stacks' own init, torch-
        Linear bounds for the untied prediction heads, the prenets' own
        init."""
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
        for m in self.modules():
            if isinstance(m, (TextPrenet, AudioPrenet)):
                m.reset_parameters(gen)


def nar_predict_weights(model: VALLE) -> torch.Tensor:
    """Stacked NAR output heads (Q-1, V, nd) in PyTorch's (out, in) layout
    (the JAX package stacks them as (Q-1, nd, V))."""
    return torch.stack([lin.weight for lin in model.nar_predict_layers])


def stage_params_mask(model: VALLE, stage: int) -> Dict[str, bool]:
    """Trainable parameter names -> whether the train stage steps them:
    stage 0 all, stage 1 the AR parameters, stage 2 the NAR ones (JAX
    ``stage_params_mask``; the reference's ``stage_parameters``)."""
    if stage not in (0, 1, 2):
        raise ValueError(f"bad stage {stage}")
    prefix = {0: "", 1: "ar_", 2: "nar_"}[stage]
    return {n: n.startswith(prefix)
            for n, p in model.named_parameters() if p.requires_grad}


def pad_y_eos(codes0: torch.Tensor, y_mask_int: torch.Tensor, eos_id: int,
              prepend_bos: bool, bos_id: int):
    """AR (inputs, targets) from quantizer-0 codes: targets shifted with
    EOS at the true length; padded positions are EOS in both."""
    targets = F.pad(codes0, (0, 1)) + eos_id * F.pad(y_mask_int, (0, 1),
                                                     value=1)
    if prepend_bos:
        return F.pad(targets[:, :-1], (1, 0), value=bos_id), targets
    return targets[:, :-1], targets[:, 1:]


def _top10_hits(logits: torch.Tensor, targets: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The count of ``valid`` positions whose target is among the 10
    largest logits."""
    k = min(10, logits.shape[-1])
    topk = logits.float().topk(k, dim=-1).indices
    hit = (topk == targets[..., None]).any(dim=-1)
    return (hit & valid).float().sum()


def top10_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   ignore_id: int) -> torch.Tensor:
    """Micro top-10 accuracy with an ignored class."""
    valid = targets != ignore_id
    return (_top10_hits(logits, targets, valid)
            / valid.float().sum().clamp_min(1.0))


def _global(batch, name: str, local):
    """The global microbatch's statistic ``name`` where the batch holds a
    rank's rows (``global_<name>``), else ``local``, this batch's own."""
    v = batch.get("global_" + name)
    return local if v is None else v.tolist()


def _accuracy(hits, count, frames, batch, global_count):
    """Top-10 accuracy ``hits / count``. On a rank's rows, its share
    hits * F / (count_g * frames) instead, F and count_g the global
    microbatch's frames and valid targets: the ranks' frames-weighted
    sums (``training._frames_weighted``) then add up to the global
    accuracy times F."""
    if "global_frames" not in batch:
        return hits / torch.as_tensor(count).float().clamp_min(1.0)
    return hits * (float(batch["global_frames"])
                   / max(float(global_count), 1.0)
                   / torch.as_tensor(frames).float().clamp_min(1.0))


def _draw_seeds(generator: Optional[torch.Generator], training: bool,
                batch, n: int = 8) -> List[Optional[int]]:
    """The forward's ``n`` dropout seeds from ``generator``; on a rank's
    rows the rank is folded into each (after the draw, so the generator's
    later draws stay the ranks' common ones)."""
    if not training or generator is None:
        return [None] * n
    seeds = torch.randint(0, 1 << 62, (n,), generator=generator).tolist()
    rank = batch.get("global_rank")
    if rank is not None:
        seeds = [fold_seed(s, int(rank)) for s in seeds]
    return seeds


def _cross_entropy_sum(logits, targets, ignore_id=None):
    """Sum-reduced cross entropy in fp32; ``ignore_id`` rows count 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = targets.clamp(max=logits.shape[-1] - 1).long()
    nll = -logp.gather(-1, idx[..., None])[..., 0]
    if ignore_id is not None:
        nll = torch.where(targets == ignore_id, torch.zeros_like(nll), nll)
    return nll.sum()


def _randint(gen: Optional[torch.Generator], low: int, high: int) -> int:
    return int(torch.randint(low, high, (), generator=gen))


def valle_forward(model: VALLE, batch: Dict[str, torch.Tensor], *,
                  train_stage: int = 0,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = False, compute_dtype=torch.float32,
                  nar_stage: Optional[int] = None,
                  nar_prefix_len: Optional[int] = None,
                  nar_prefix_starts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: (loss_sum, metrics).

    batch: ``text`` (B, S) int, ``text_lens`` (B,), ``audio`` (B, T, Q)
    int, ``audio_lens`` (B,); prefix mode 4 also ``prompt_codes`` (B, P, Q)
    and ``prompt_lens`` (B,) with equal entries. ``generator`` (on the
    CPU) draws dropout seeds and the NAR stage/prefix when
    ``deterministic`` is False; ``nar_stage``, ``nar_prefix_len`` (mode 1)
    and ``nar_prefix_starts`` (B,; mode 2) pin those draws. Metrics as the
    JAX forward: top-10 accuracies (fractions), ar_loss / nar_loss sums,
    frames.
    """
    cfg = model.cfg
    training = not deterministic
    seeds = _draw_seeds(generator, training, batch)
    reduce_stats = ranks_share(batch)
    text = batch["text"].long()
    x_lens = batch["text_lens"].long()
    y = batch["audio"].long()
    y_lens = batch["audio_lens"].long()
    S, T = text.shape[1], y.shape[1]
    dev = text.device

    y_mask_int = (torch.arange(T, device=dev)[None, :]
                  >= y_lens[:, None]).long()
    codes = y * (1 - y_mask_int[..., None])
    ar_y, ar_targets = pad_y_eos(codes[..., 0], y_mask_int, cfg.eos_id,
                                 cfg.prepend_bos, cfg.bos_id)
    frames = y_lens.sum().float()
    rows = int(_global(batch, "rows", text.shape[0]))
    metrics: Dict[str, torch.Tensor] = {}
    total_loss = torch.zeros((), device=dev)
    stack_kw = dict(activation=cfg.activation, dtype=compute_dtype,
                    score_bf16=cfg.attn_score_bf16, dropout_rate=cfg.dropout,
                    remat=cfg.remat if training else "none")

    if train_stage in (0, 1):
        x = text_frontend(model, "ar", text, compute_dtype,
                          training=training, seed=seeds[0],
                          reduce_stats=reduce_stats)
        bos = int(cfg.prepend_bos)
        ar_y_lens = y_lens + bos
        y_pos = ar_audio_frontend(model, ar_y, compute_dtype,
                                  training=training, seed=seeds[1])
        layer_seeds = _layer_seeds(seeds[2], cfg.num_layers)
        if cfg.model_name == "vallf":
            # audio causal self-attention; the text is the memory
            self_bias = (M.causal_bias(T + bos, dev)
                         + M.key_padding_bias(ar_y_lens, T + bos))
            y_dec = decoder_stack_apply(
                model.ar_decoder, y_pos, x, self_bias,
                M.key_padding_bias(x_lens, S), None, seeds=layer_seeds,
                **stack_kw)
        else:
            if cfg.attn_impl == "flash":
                bias = None
                qc, kc = M.flash_codes_ar_xy(x_lens, ar_y_lens, S, T + bos)
                fspec = {"qcode": qc, "kcode": kc}
            else:
                bias = M.ar_xy_attn_bias(x_lens, ar_y_lens, S, T + bos)
                fspec = None
            y_dec = encoder_stack_apply(
                model.ar_decoder, torch.cat([x, y_pos], dim=1), bias, None,
                flash_spec=fspec, seeds=layer_seeds, **stack_kw)[:, S:]
        logits = y_dec @ model.ar_predict_layer.weight.to(y_dec.dtype).T
        ar_loss = _cross_entropy_sum(logits, ar_targets)
        total_loss = total_loss + ar_loss
        # a row's non-EOS targets: its frames, one fewer without BOS
        valid = ar_targets != cfg.eos_id
        metrics["ArTop10Accuracy"] = _accuracy(
            _top10_hits(logits, ar_targets, valid), valid.sum(), frames,
            batch, _global(batch, "frames", 0) - (1 - bos) * rows)
        metrics["ar_loss"] = ar_loss

    if cfg.num_quantizers > 1 and train_stage in (0, 2):
        nar_y = ar_y[:, 1:] if cfg.prepend_bos else ar_y
        if nar_stage is None:
            nar_stage = (_randint(generator, 1, cfg.num_quantizers)
                         if training and generator is not None else 1)
        xn = text_frontend(model, "nar", text, compute_dtype,
                           training=training, seed=seeds[4],
                           reduce_stats=reduce_stats)
        nar_loss, nar_acc = _nar_branch(
            model, xn, x_lens, nar_y, codes, y_lens, y_mask_int,
            int(nar_stage), batch, seeds, generator, training, compute_dtype,
            stack_kw, frames, rows, nar_prefix_len, nar_prefix_starts)
        total_loss = total_loss + nar_loss
        metrics["NarTop10Accuracy"] = nar_acc
        metrics["nar_loss"] = nar_loss

    if train_stage == 0 and cfg.num_quantizers > 1:
        total_loss = total_loss / 2.0
    metrics["frames"] = frames
    return total_loss, metrics


def _fold(seed: Optional[int], i: int) -> Optional[int]:
    return None if seed is None else fold_seed(seed, i)


def text_frontend(model: VALLE, branch: str, text, dtype, *,
                  training: bool = False, seed: Optional[int] = None,
                  reduce_stats: bool = False):
    """JAX ``_text_frontend``: the ``branch``'s ("ar" or "nar") text
    embedding, its text prenet (``training``: batch statistics; dropout
    under ``seed``), then positions, with dropout 0.1 on the AR branch."""
    cfg = model.cfg
    d = cfg.d_model if branch == "ar" else cfg.nar_d_model
    x = token_embedding(
        getattr(model, branch + "_text_embedding").word_embeddings.weight,
        text, dtype)
    if cfg.add_prenet:
        x = text_prenet(getattr(model, branch + "_text_prenet"), x,
                        training=training, seed=_fold(seed, 1),
                        reduce_stats=reduce_stats)
    return apply_sine_positional(
        getattr(model, branch + "_text_position").alpha, x,
        pe_table(cfg, d, device=text.device),
        dropout_rate=0.1 if branch == "ar" else 0.0, seed=seed)


def ar_audio_frontend(model: VALLE, ar_y, dtype, *, training: bool = False,
                      seed: Optional[int] = None):
    """JAX ``_ar_audio_frontend``: the AR audio embedding, its prenet, then
    positions with dropout 0.1."""
    cfg = model.cfg
    y = token_embedding(model.ar_audio_embedding.word_embeddings.weight,
                        ar_y, dtype)
    if cfg.add_prenet:
        y = audio_prenet(model.ar_audio_prenet, y, training=training,
                         seed=_fold(seed, 3))
    return apply_sine_positional(
        model.ar_audio_position.alpha, y,
        pe_table(cfg, cfg.d_model, device=ar_y.device), dropout_rate=0.1,
        seed=seed)


def _layer_seeds(seed: Optional[int], n: int) -> Optional[List[int]]:
    return None if seed is None else [fold_seed(seed, i) for i in range(n)]


def _nar_embedding_sum(embs: List[torch.Tensor], nar_y, codes, nar_stage,
                       region_all: Optional[torch.Tensor], num_q: int, dtype):
    """y_emb[t] = emb0(nar_y[t]) + sum_j emb_j(codes_j[t]) over j <
    nar_stage, and over every j where ``region_all`` (B, T) is set (the
    acoustic prompt region)."""
    acc = token_embedding(embs[0], nar_y, dtype)
    for j in range(1, num_q):
        if j < nar_stage:
            acc = acc + token_embedding(embs[j], codes[..., j], dtype)
        elif region_all is not None:
            e = token_embedding(embs[j], codes[..., j], dtype)
            acc = acc + torch.where(region_all[..., None], e,
                                    torch.zeros_like(e))
    return acc


def _nar_padding_mask(cfg, x_lens, y_lens, S, T):
    """(bias, flash_spec) of the NAR padding-only mask, per attn_impl."""
    if cfg.attn_impl == "flash":
        qc, kc = M.flash_codes_padding(x_lens, y_lens, S, T)
        return None, {"qcode": qc, "kcode": kc}
    return M.padding_attn_bias(x_lens, y_lens, S, T), None


def _nar_branch(model: VALLE, xn, x_lens, nar_y, codes, y_lens, y_mask_int,
                nar_stage: int, batch, seeds, generator, training,
                compute_dtype, stack_kw, frames, rows,
                prefix_len_override=None,
                prefix_starts_override=None):
    """NAR loss (JAX ``_nar_branch`` and, for VALL-F, ``_nar_branch_vallf``:
    the same prompt logic, the audio alone in the sequence and the text
    ``xn`` as the cross-attention memory). Returns (loss, top-10 acc).
    The prefix length and the loss scale come from the global
    microbatch's lengths (``_global``)."""
    cfg = model.cfg
    B, T = nar_y.shape
    S = xn.shape[1]
    dev = xn.device
    V, Q = cfg.num_audio_tokens, cfg.num_quantizers
    embs = [e.word_embeddings.weight for e in model.nar_audio_embeddings]
    pe = pe_table(cfg, cfg.nar_d_model, device=dev)
    alpha = model.nar_audio_position.alpha
    total_length = _global(batch, "frames", frames)
    pos_t = torch.arange(T, device=dev)[None, :]
    targets = codes[..., nar_stage] + V * y_mask_int     # pads -> ignore id
    draw = training and generator is not None

    vallf = cfg.model_name == "vallf"

    def post(emb, offset, seed):
        if cfg.add_prenet:
            emb = audio_prenet(model.nar_audio_prenet, emb,
                               training=training, seed=_fold(seed, 5))
        return apply_sine_positional(alpha, emb, pe, offset=offset,
                                     dropout_rate=0.1, seed=seed)

    if cfg.prefix_mode in (0, 1):
        prefix_len, region_all = 0, None
        tgt_full, loss_scale = targets, 1.0
        if cfg.prefix_mode == 1:
            # prefix at the start of the same utterance: a length in
            # [min_len / 4, min_len / 2), capped at max_prefix_len
            int_low = int(0.25 * int(_global(batch, "min_len",
                                             y_lens.min())))
            if prefix_len_override is not None:
                prefix_len = int(prefix_len_override)
            elif draw:
                prefix_len = _randint(generator, int_low,
                                      max(int_low * 2, int_low + 1))
            else:
                prefix_len = int_low
            prefix_len = min(prefix_len, cfg.max_prefix_len)
            region_all = (pos_t < prefix_len).expand(B, T)
            tgt_full = torch.where(region_all, V, targets)
            loss_scale = total_length / (total_length - prefix_len * rows)
        y_emb = _nar_embedding_sum(embs, nar_y, codes, nar_stage, region_all,
                                   Q, compute_dtype)
        seq = [post(y_emb, 0, seeds[5])]
        if vallf:
            bias, fspec = M.key_padding_bias(y_lens, T), None
        else:
            bias, fspec = _nar_padding_mask(cfg, x_lens, y_lens, S, T)
    elif cfg.prefix_mode in (2, 4):
        if cfg.prefix_mode == 2:
            # a random interior segment of each utterance is the prompt
            P = cfg.max_prefix_len
            prefix_len = min(P, int(0.25 * int(_global(batch, "min_len",
                                                       y_lens.min()))))
            if prefix_starts_override is not None:
                starts = torch.as_tensor(prefix_starts_override,
                                         device=dev).long()
            elif draw:
                # one start a row of the global microbatch, in order; a
                # rank keeps its own rows'
                lens = _global(batch, "lens", y_lens.tolist())
                row0 = int(_global(batch, "row0", 0))
                hi = [max(n - prefix_len + 1, 1) for n in lens]
                starts = torch.tensor(
                    [_randint(generator, 0, h) for h in hi][row0:row0 + B],
                    device=dev)
            else:
                starts = torch.zeros(B, dtype=torch.long, device=dev)
            codes_pad = F.pad(codes, (0, 0, 0, P))
            idx = starts[:, None] + torch.arange(P, device=dev)[None, :]
            prompt_codes = codes_pad.gather(
                1, idx[..., None].expand(B, P, Q))
            prompt_lens = torch.full((B,), prefix_len, device=dev)
            in_src = (pos_t >= starts[:, None]) & (
                pos_t < starts[:, None] + prefix_len)
            tgt_full = torch.where(in_src, V, targets)
            loss_scale = total_length / (total_length - prefix_len * rows)
        else:  # mode 4: neighbour-utterance prompts from the data layer
            prompt_codes = batch["prompt_codes"].long()
            P = prompt_codes.shape[1]
            prompt_lens = batch["prompt_lens"].long()
            prefix_len = int(_global(batch, "prompt_len0", prompt_lens[0]))
            tgt_full, loss_scale = targets, 1.0
        prompt_valid = (torch.arange(P, device=dev)[None, :]
                        < prompt_lens[:, None])
        prompt_codes = prompt_codes * prompt_valid[..., None]
        p_emb = token_embedding(embs[0], prompt_codes[..., 0], compute_dtype)
        for j in range(1, Q):        # the prompt sums every quantizer
            p_emb = p_emb + token_embedding(embs[j], prompt_codes[..., j],
                                            compute_dtype)
        y_emb = _nar_embedding_sum(embs, nar_y, codes, nar_stage, None, Q,
                                   compute_dtype)
        # positions: prompt at [0, P), y at [prefix_len, prefix_len + T)
        seq = [post(p_emb, 0, seeds[5]), post(y_emb, prefix_len, seeds[7])]
        Sx = 0 if vallf else S
        kk = torch.arange(Sx + P + T, device=dev)[None, :]
        key_valid = torch.where(
            kk < Sx, kk < x_lens[:, None],
            torch.where(kk < Sx + P, (kk - Sx) < prompt_lens[:, None],
                        (kk - Sx - P) < y_lens[:, None]))
        if cfg.attn_impl == "flash" and not vallf:
            qc, kc = M.flash_codes_key_valid(key_valid)
            bias, fspec = None, {"qcode": qc, "kcode": kc}
        else:
            bias = torch.zeros(key_valid.shape, device=dev).masked_fill(
                ~key_valid, M.NEG_INF)[:, None, None, :]
            fspec = None
    else:
        raise ValueError(f"unsupported prefix_mode {cfg.prefix_mode}")

    cond = model.nar_stage_embeddings[nar_stage - 1].word_embeddings.weight
    stack_seeds = _layer_seeds(_fold(seeds[5], 1 << 20), cfg.nar_num_layers)
    if vallf:
        dec = decoder_stack_apply(
            model.nar_decoder, torch.cat(seq, dim=1), xn, bias,
            M.key_padding_bias(x_lens, S), cond, seeds=stack_seeds,
            **stack_kw)
    else:
        dec = encoder_stack_apply(
            model.nar_decoder, torch.cat([xn] + seq, dim=1), bias, cond,
            flash_spec=fspec, seeds=stack_seeds, **stack_kw)
    y_dec = dec[:, -T:]   # the y region is always the trailing T
    W = model.nar_predict_layers[nar_stage - 1].weight      # (V, nd)
    logits = y_dec @ W.to(y_dec.dtype).T
    nar_loss = _cross_entropy_sum(logits, tgt_full, ignore_id=V) * loss_scale
    valid = tgt_full != V
    # modes 1 and 2 take prefix_len frames of every row out of the targets
    masked = prefix_len * rows if cfg.prefix_mode in (1, 2) else 0
    return nar_loss, _accuracy(
        _top10_hits(logits, tgt_full, valid), valid.sum(), frames, batch,
        total_length - masked)


def _packed_mask(cfg: ValleConfig, text_seg, audio_seg, codes_fn, bias_fn):
    """(bias, flash_spec) of a packed row's mask, per attn_impl; the
    kernels see padding only on their own diagonal (``add_diag``)."""
    if cfg.attn_impl == "flash":
        qc, kc, qs, ks = codes_fn(text_seg, audio_seg)
        return None, {"qcode": qc, "kcode": kc, "qseg": qs, "kseg": ks,
                      "add_diag": True}
    return bias_fn(text_seg, audio_seg), None


def valle_ar_forward_packed(model: VALLE, batch: Dict[str, torch.Tensor], *,
                            train_stage: int = 1,
                            generator: Optional[torch.Generator] = None,
                            deterministic: bool = False,
                            compute_dtype=torch.float32
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """AR training forward over sequence-packed rows: (loss_sum, metrics).

    batch (``data.packing.PackedSpeechDataset``): ``text`` (B, S),
    ``text_seg`` / ``text_pos`` (B, S), ``ar_inputs`` / ``ar_targets``
    (B, T) with -1 targets at padding, ``audio_seg`` / ``audio_pos``
    (B, T), ``row_frames`` (B,). Each segment's math is the AR branch of
    ``valle_forward`` at its exact length: the loss equals the sum of the
    segments' unpacked losses. Metrics as the JAX forward: the top-10
    accuracy over non-EOS targets, ``ar_loss``, ``frames`` and
    ``utterances``."""
    if train_stage not in (0, 1):
        raise ValueError("the packed forward is AR-only (train stage 0/1)")
    cfg = model.cfg
    if cfg.add_prenet:
        raise NotImplementedError("packed AR rows do not support prenets")
    if cfg.model_name != "valle":
        raise NotImplementedError("packed rows are VALL-E's only")
    training = not deterministic
    seeds = _draw_seeds(generator, training, batch, 4)
    pe = pe_table(cfg, cfg.d_model, device=batch["text"].device)
    text_seg, audio_seg = batch["text_seg"].long(), batch["audio_seg"].long()
    ar_targets = batch["ar_targets"].long()

    x = apply_sine_positional_gather(
        model.ar_text_position.alpha,
        token_embedding(model.ar_text_embedding.word_embeddings.weight,
                        batch["text"], compute_dtype),
        pe, batch["text_pos"], dropout_rate=0.1, seed=seeds[0])
    y = apply_sine_positional_gather(
        model.ar_audio_position.alpha,
        token_embedding(model.ar_audio_embedding.word_embeddings.weight,
                        batch["ar_inputs"], compute_dtype),
        pe, batch["audio_pos"], dropout_rate=0.1, seed=seeds[1])
    bias, fspec = _packed_mask(cfg, text_seg, audio_seg,
                               M.flash_codes_packed_ar,
                               M.packed_ar_attn_bias)
    xy_dec = encoder_stack_apply(
        model.ar_decoder, torch.cat([x, y], dim=1), bias, None,
        flash_spec=fspec, seeds=_layer_seeds(seeds[2], cfg.num_layers),
        activation=cfg.activation, dtype=compute_dtype,
        score_bf16=cfg.attn_score_bf16, dropout_rate=cfg.dropout,
        remat=cfg.remat if training else "none")
    S = text_seg.shape[1]
    logits = xy_dec[:, S:] @ model.ar_predict_layer.weight.to(xy_dec.dtype).T

    valid = ar_targets >= 0
    tgt = ar_targets.clamp_min(0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    ar_loss = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    frames = batch["row_frames"].sum().float()
    utterances = (audio_seg.amax(dim=1) + 1).sum().float()
    # a segment's one EOS target is the valid target the accuracy skips
    metric_valid = valid & (tgt != cfg.eos_id)
    acc = _accuracy(
        _top10_hits(logits, tgt, metric_valid), metric_valid.sum(), frames,
        batch, _global(batch, "targets", 0) - _global(batch, "segments", 0))
    return ar_loss, {"ArTop10Accuracy": acc, "ar_loss": ar_loss,
                     "frames": frames, "utterances": utterances}


def valle_nar_forward_packed(model: VALLE, batch: Dict[str, torch.Tensor], *,
                             train_stage: int = 2,
                             generator: Optional[torch.Generator] = None,
                             deterministic: bool = False,
                             compute_dtype=torch.float32,
                             nar_stage: Optional[int] = None,
                             nar_prefix_len: Optional[int] = None
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """NAR training forward over sequence-packed rows (prefix modes 0/1):
    (loss_sum, metrics).

    batch (``data.packing.PackedNarSpeechDataset``): ``text`` (B, S),
    ``text_seg`` / ``text_pos`` (B, S), ``nar_codes`` (B, T, Q) with zeros
    at padding, ``audio_seg`` / ``audio_pos`` (B, T), ``seg_frames`` (B,
    K) the rows' segment lengths (0 for empty slots), ``row_frames``
    (B,). Each segment's math is the NAR branch of ``valle_forward``;
    prefix mode 1 draws one prefix length per step from [min_len / 4,
    min_len / 2) over every packed segment (capped at max_prefix_len) and
    scales the loss by total / (total - prefix_len * segments).
    ``nar_stage`` / ``nar_prefix_len`` pin the draws."""
    if train_stage != 2:
        raise ValueError("the packed NAR forward is NAR-stage only")
    cfg = model.cfg
    if cfg.add_prenet:
        raise NotImplementedError("packed NAR rows do not support prenets")
    if cfg.model_name != "valle":
        raise NotImplementedError("packed rows are VALL-E's only")
    if cfg.prefix_mode not in (0, 1):
        raise NotImplementedError(
            "packed NAR supports prefix modes 0/1 (modes 2/4 splice prompt "
            "segments; use the bucketed path)")
    training = not deterministic
    draw = training and generator is not None
    seeds = _draw_seeds(generator, training, batch)
    V, Q = cfg.num_audio_tokens, cfg.num_quantizers
    codes = batch["nar_codes"].long()
    text_seg, audio_seg = batch["text_seg"].long(), batch["audio_seg"].long()
    audio_pos = batch["audio_pos"].long()
    seg_frames = batch["seg_frames"].long()
    T = codes.shape[1]
    pe = pe_table(cfg, cfg.nar_d_model, device=codes.device)

    if nar_stage is None:
        nar_stage = _randint(generator, 1, Q) if draw else 1
    nar_stage = int(nar_stage)
    real_seg = seg_frames > 0
    frames = seg_frames.sum().float()
    n_seg = _global(batch, "segments", real_seg.sum().float())
    total = _global(batch, "frames", frames)
    prefix_len = 0
    if cfg.prefix_mode == 1:
        # one prefix length a step over every packed segment
        local_min = (int(seg_frames[real_seg].min()) if bool(real_seg.any())
                     else 1 << 30)
        int_low = int(0.25 * int(_global(batch, "min_len", local_min)))
        if nar_prefix_len is not None:
            prefix_len = int(nar_prefix_len)
        elif draw:
            prefix_len = _randint(generator, int_low,
                                  max(int_low * 2, int_low + 1))
        else:
            prefix_len = int_low
        prefix_len = min(prefix_len, cfg.max_prefix_len)
    seg_valid = audio_seg >= 0
    region_all = ((audio_pos < prefix_len) & seg_valid
                  if prefix_len > 0 else None)

    embs = [e.word_embeddings.weight for e in model.nar_audio_embeddings]
    x = apply_sine_positional_gather(
        model.nar_text_position.alpha,
        token_embedding(model.nar_text_embedding.word_embeddings.weight,
                        batch["text"], compute_dtype),
        pe, batch["text_pos"])
    y_emb = _nar_embedding_sum(embs, codes[..., 0], codes, nar_stage,
                               region_all, Q, compute_dtype)
    y = apply_sine_positional_gather(
        model.nar_audio_position.alpha, y_emb, pe, audio_pos,
        dropout_rate=0.1, seed=seeds[5])
    bias, fspec = _packed_mask(cfg, text_seg, audio_seg,
                               M.flash_codes_packed_nar,
                               M.packed_nar_attn_bias)
    cond = model.nar_stage_embeddings[nar_stage - 1].word_embeddings.weight
    stack_seed = None if seeds[5] is None else fold_seed(seeds[5], 1 << 20)
    xy_dec = encoder_stack_apply(
        model.nar_decoder, torch.cat([x, y], dim=1), bias, cond,
        flash_spec=fspec,
        seeds=_layer_seeds(stack_seed, cfg.nar_num_layers),
        activation=cfg.activation, dtype=compute_dtype,
        score_bf16=cfg.attn_score_bf16, dropout_rate=cfg.dropout,
        remat=cfg.remat if training else "none")
    y_dec = xy_dec[:, -T:]
    W = model.nar_predict_layers[nar_stage - 1].weight
    logits = y_dec @ W.to(y_dec.dtype).T

    masked = ~seg_valid if region_all is None else region_all | ~seg_valid
    tgt_full = torch.where(masked, V, codes[..., nar_stage])
    loss_scale = 1.0
    if cfg.prefix_mode == 1:
        loss_scale = total / torch.as_tensor(
            total - prefix_len * n_seg).clamp_min(1.0)
    nar_loss = _cross_entropy_sum(logits, tgt_full, ignore_id=V) * loss_scale
    valid = ~masked
    acc = _accuracy(_top10_hits(logits, tgt_full, valid), valid.sum(),
                    frames, batch, total - prefix_len * n_seg)
    return nar_loss, {"NarTop10Accuracy": acc, "nar_loss": nar_loss,
                      "frames": frames,
                      "utterances": real_seg.sum().float()}
