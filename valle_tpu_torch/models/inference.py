"""Zero-shot TTS inference: KV-cache AR decode + 7 NAR passes, for VALL-E
(``valle_ar_decode``) and VALL-F (``vallf_ar_decode``: a self-attention
cache over the audio plus cross-attention to the text's projections, made
once by the prefill).

Mirror of ``valle_tpu/models/inference.py`` with the same semantics:

- AR stop rule: argmax == EOS, or sampled == EOS, or (g + bos) > 16 x
  text length; the sample that triggers a stop is discarded.
- NAR: Q-1 sequential argmax passes; the acoustic-prompt embedding
  schedule differs between prefix_mode 0 and modes 1/2/4 as in the
  reference; modes 2/4 cut the enrolled phonemes out of the NAR text.

The AR loop is a Python loop over steps with one ``done.all()`` check per
step; the KV cache is updated in place: (L, B, H, T, Dh) k/v in the plain
modes, or the layout of the attention kernel's mode (``convert_cache``,
``modules/transformer.py:CACHE_KINDS``). The JAX decode
step adds the bare PE row to each new token, dropping the learnable
``alpha`` that its prefill applies; the port applies ``alpha`` in the
decode step too, which is the reference's full-sequence semantics (the
two agree at alpha = 1, the value at init). With prenets, the text prenet
reads the running statistics, and the audio prenet (pointwise) applies to
each step's embedding before the positions, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..modules.embedding import token_embedding
from ..modules.prenet import audio_prenet
from ..modules.transformer import (CACHE_KINDS, FUSED_MODES,
                                   decoder_stack_apply,
                                   decoder_stack_decode_step,
                                   decoder_stack_prefill,
                                   encoder_stack_apply,
                                   encoder_stack_decode_step,
                                   encoder_stack_prefill, quantize_kv,
                                   quantize_stack_weights)
from ..ops import masks as M
from ..ops.sampling import (categorical, check_draws,
                            top_k_top_p_filtering)
from .valle import (VALLE, ar_audio_frontend, nar_predict_weights, pe_table,
                    text_frontend)

DECODE_MODES = ("exact", "unroll", "fused", "fused_w8", "int8", "fused_int8",
                "bf16", "fused_kv", "lanes", "fused_lanes", "mega")
# the transposed-cache modes of JAX's valle_ar_decode(use_decode_kernel=True,
# decode_kernel_mode=...), which its valle_inference does not expose
AR_DECODE_MODES = DECODE_MODES + ("grouped", "per_sample")
# the JAX package's substitutes for its 8-row grouped modes when B % 8 != 0
# (valle_tpu/models/inference.py:159-164, 761-771)
UNGROUPED_MODES = {"int8": "exact", "bf16": "exact", "lanes": "exact",
                   "fused_int8": "fused", "fused_kv": "fused",
                   "fused_lanes": "fused", "mega": "fused",
                   "grouped": "per_sample"}


def cache_rows(cache_len: int, mode: str, nhead: int) -> int:
    """The JAX package's cache rounding (valle_tpu/models/inference.py
    :166-189): 256 rows for the int8 modes (min(preferred_block(H), 256))
    and "per_sample" (B8's block), 128 for the other attention-kernel
    modes, none for the plain modes. Kept so that caches compare shape for
    shape with JAX's; the CUDA kernels do not need it."""
    from ..ops import decode_attention, decode_attention_grouped
    from ..ops.decode_attention_int8_grouped import preferred_block

    kind = CACHE_KINDS.get(mode)
    if kind is None:
        return cache_len
    blk = {"int8": min(preferred_block(nhead), 256),
           "t": (decode_attention.BLOCK_K if mode == "per_sample"
                 else decode_attention_grouped.BLOCK_K)}.get(kind, 128)
    return ((cache_len + blk - 1) // blk) * blk


def convert_cache(cache, mode: str):
    """The prefill's {"k", "v"} (L, B, H, T, Dh) cache -> the layout of the
    mode's attention kernel, once per call (valle_tpu/models/inference.py
    :201-236). The int8 cache quantizes every row, the zero rows past the
    prefill included (they get the 1e-8 scale); the transposed modes swap
    the last two axes into contiguous (L, B, H, Dh, T) caches."""
    from ..ops.decode_attention_int8_grouped import (combine_kv_int8,
                                                     stack_scales)
    from ..ops.decode_attention_kv import combine_kv
    from ..ops.decode_attention_lanes import combine_kv_lanes

    kind = CACHE_KINDS.get(mode)
    if kind == "int8":
        kq, ks = quantize_kv(cache["k"])
        vq, vs = quantize_kv(cache["v"])
        return {"kv": combine_kv_int8(kq, vq), "scale": stack_scales(ks, vs)}
    if kind == "kv":
        return {"kv": combine_kv(cache["k"], cache["v"])}
    if kind == "lanes":
        return {"kv": combine_kv_lanes(cache["k"], cache["v"])}
    if kind == "t":
        return {n: cache[n].transpose(-1, -2).contiguous() for n in ("k", "v")}
    return cache


def _frontends(model: VALLE, text, prompt_q0, dtype):
    """Embed text and the audio prefix with positions (inference; the
    prenets deterministic)."""
    cfg = model.cfg
    x = text_frontend(model, "ar", text, dtype)
    if cfg.prepend_bos:
        prompt_q0 = F.pad(prompt_q0, (1, 0), value=cfg.bos_id)
    return x, ar_audio_frontend(model, prompt_q0, dtype)


def ar_stop_step(logits, g, done, gen_lens, x_lens, cfg, *, generator,
                 top_k: int, temperature: float, invalid,
                 extra_stop=None, force_full_length: bool = False):
    """One AR step's draw and the reference stop rule over a batch: a row
    stops on argmax EOS, sampled EOS, (g + bos) > 16 x its text length,
    or ``extra_stop``; the sample that stops it is discarded, and its
    length is its g there. ``force_full_length`` disables the rule.
    Returns (tok, done, gen_lens): the token each row embeds next (EOS
    once done)."""
    eos, bos = cfg.eos_id, int(cfg.prepend_bos)
    lg = top_k_top_p_filtering(logits / temperature, top_k=top_k)
    samples = categorical(lg, generator, invalid)
    argmaxes = logits.argmax(dim=-1)
    # the reference's cap counts the prepended BOS
    stop = (argmaxes == eos) | (samples == eos) | ((g + bos) > x_lens * 16)
    if extra_stop is not None:
        stop = stop | extra_stop
    if force_full_length:
        stop = torch.zeros_like(stop)
    gen_lens = torch.where(stop & ~done, g, gen_lens).to(torch.int32)
    done = done | stop
    return torch.where(done, eos, samples), done, gen_lens


def ar_step_input(model: VALLE, tok, audio_pos, pe, dtype):
    """The accepted tokens embedded (and through the audio prenet) at
    audio positions ``audio_pos`` with ``alpha * pe`` (ROADMAP C4), PE
    positions clipped to max_len - 1 as JAX's gather clips them: (B, 1,
    D)."""
    e = token_embedding(model.ar_audio_embedding.word_embeddings.weight,
                        tok, dtype)
    if model.cfg.add_prenet:
        e = audio_prenet(model.ar_audio_prenet, e)
    alpha = model.ar_audio_position.alpha.to(dtype)
    rows = pe[audio_pos.clamp(0, model.cfg.max_len - 1)].to(dtype)
    return (e + alpha * rows)[:, None, :]


def decode_step_bias(x_lens, write_pos, S: int, kk):
    """(B, 1, 1, T) additive bias of a decode step over cache positions
    ``kk`` (1, T): each row sees its text keys and its audio keys from S
    up to its write position."""
    key_valid = (kk < x_lens[:, None]) | (
        (kk >= S) & (kk <= write_pos[:, None]))
    bias = torch.zeros(key_valid.shape, device=kk.device)
    bias.masked_fill_(~key_valid, M.NEG_INF)
    return bias[:, None, None, :]


@torch.no_grad()
def valle_ar_decode(model: VALLE, text, text_lens, prompt_q0, prompt_lens,
                    *, generator: Optional[torch.Generator] = None,
                    top_k: int = -100, temperature: float = 1.0,
                    max_gen_len: int = 1024,
                    compute_dtype=torch.float32,
                    force_full_length: bool = False,
                    aligned_prompts: bool = False,
                    decode_mode: str = "exact"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched KV-cache AR decode of quantizer-0 codes.

    Returns (gen_codes (B, max_gen_len) int32, gen_lens (B,) int32).
    ``force_full_length`` disables the stop rule (every row decodes
    ``max_gen_len`` tokens); ``aligned_prompts`` asserts one prompt length
    for all rows, so the cache write is one slice per layer.
    ``decode_mode`` is resolved by ``resolve_decode_mode`` first; besides
    the modes of ``valle_inference`` it takes "grouped" (B9) and
    "per_sample" (B8), JAX's ``use_decode_kernel`` modes over a transposed
    cache ("grouped" runs as "per_sample" at B % 8 != 0).
    """
    cfg = model.cfg
    if cfg.model_name != "valle":
        raise ValueError("valle_ar_decode decodes VALL-E; VALL-F decodes "
                         "with vallf_ar_decode")
    dev = text.device
    B, S = text.shape
    P = prompt_q0.shape[1]
    decode_mode = resolve_decode_mode(decode_mode, cfg, B=B, S=S, P=P,
                                      max_gen_len=max_gen_len)
    bos = int(cfg.prepend_bos)
    dtype = compute_dtype
    x_lens = text_lens.to(dev, torch.int64)
    p_lens = prompt_lens.to(dev, torch.int64) + bos
    cache_len = cache_rows(S + bos + P + max_gen_len + 1, decode_mode,
                           cfg.nhead)
    kernel_attn = decode_mode in CACHE_KINDS

    x, y = _frontends(model, text, prompt_q0, dtype)
    bias = M.ar_xy_attn_bias(x_lens, p_lens, S, bos + P)
    dec = model.ar_decoder
    hidden, cache = encoder_stack_prefill(
        dec, torch.cat([x, y], dim=1), bias, cache_len=cache_len,
        activation=cfg.activation, dtype=dtype)
    cache = convert_cache(cache, decode_mode)
    w8 = quantize_stack_weights(dec) if decode_mode == "fused_w8" else None
    x_lens32 = x_lens.to(torch.int32)

    W = model.ar_predict_layer.weight.to(dtype)      # (V+1, D)
    bidx = torch.arange(B, device=dev)
    logits = (hidden[bidx, S + p_lens - 1] @ W.T).float()
    pe = pe_table(cfg, cfg.d_model, device=dev)
    kk = torch.arange(cache_len, device=dev)[None, :]

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    invalid = torch.zeros(B, dtype=torch.bool, device=dev)
    gen_codes = torch.zeros(B, max_gen_len, dtype=torch.int32, device=dev)
    gen_lens = torch.full((B,), max_gen_len, dtype=torch.int32, device=dev)
    for g in range(max_gen_len):
        if not force_full_length and bool(done.all()):
            break
        tok, done, gen_lens = ar_stop_step(
            logits, g, done, gen_lens, x_lens, cfg, generator=generator,
            top_k=top_k, temperature=temperature, invalid=invalid,
            force_full_length=force_full_length)
        gen_codes[:, g] = torch.where(done, 0, tok).to(torch.int32)

        # embed the accepted token at audio position p_lens + g
        if aligned_prompts:
            audio_pos = p_lens[:1] + g
            write_pos = (S + audio_pos)[0]
        else:
            audio_pos = p_lens + g
            write_pos = S + audio_pos
        xstep = ar_step_input(model, tok, audio_pos, pe, dtype)
        wp = write_pos.expand(B) if aligned_prompts else write_pos
        if kernel_attn:   # the kernels apply the validity rule themselves
            step_bias = None
            kctx = (x_lens32, wp.to(torch.int32).contiguous(), S)
        else:
            step_bias = decode_step_bias(x_lens, wp, S, kk)
            kctx = None
        hidden_s = encoder_stack_decode_step(
            dec, xstep, cache, write_pos, step_bias,
            activation=cfg.activation, dtype=dtype, mode=decode_mode, w8=w8,
            kernel_ctx=kctx)
        logits = (hidden_s[:, 0] @ W.T).float()
    check_draws(invalid, "valle_ar_decode")
    return gen_codes, gen_lens


@torch.no_grad()
def vallf_ar_decode(model: VALLE, text, text_lens, prompt_q0, prompt_lens,
                    *, generator: Optional[torch.Generator] = None,
                    top_k: int = -100, temperature: float = 1.0,
                    max_gen_len: int = 1024, compute_dtype=torch.float32,
                    force_full_length: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VALL-F's KV-cache AR decode (JAX ``vallf_ar_decode``): causal
    self-attention over the audio with cross-attention to the encoded
    text, whose projections the prefill makes once. The stop rule, the
    step's input and the draws are ``valle_ar_decode``'s; the plain path
    alone, as in JAX. Returns (gen_codes (B, max_gen_len) int32, gen_lens
    (B,) int32)."""
    cfg = model.cfg
    if cfg.model_name != "vallf":
        raise ValueError("vallf_ar_decode decodes VALL-F")
    dev = text.device
    B, S = text.shape
    P = prompt_q0.shape[1]
    bos = int(cfg.prepend_bos)
    dtype = compute_dtype
    x_lens = text_lens.to(dev, torch.int64)
    p_lens = prompt_lens.to(dev, torch.int64) + bos
    cache_len = bos + P + max_gen_len + 1

    x, y = _frontends(model, text, prompt_q0, dtype)
    cross_bias = M.key_padding_bias(x_lens, S)
    Ty = bos + P
    self_bias = M.causal_bias(Ty, dev) + M.key_padding_bias(p_lens, Ty)
    dec = model.ar_decoder
    hidden, cache = decoder_stack_prefill(
        dec, y, x, self_bias, cross_bias, cache_len=cache_len,
        activation=cfg.activation, dtype=dtype)
    W = model.ar_predict_layer.weight.to(dtype)
    bidx = torch.arange(B, device=dev)
    logits = (hidden[bidx, p_lens - 1] @ W.T).float()
    pe = pe_table(cfg, cfg.d_model, device=dev)
    kk = torch.arange(cache_len, device=dev)[None, :]

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    invalid = torch.zeros(B, dtype=torch.bool, device=dev)
    gen_codes = torch.zeros(B, max_gen_len, dtype=torch.int32, device=dev)
    gen_lens = torch.full((B,), max_gen_len, dtype=torch.int32, device=dev)
    for g in range(max_gen_len):
        if not force_full_length and bool(done.all()):
            break
        tok, done, gen_lens = ar_stop_step(
            logits, g, done, gen_lens, x_lens, cfg, generator=generator,
            top_k=top_k, temperature=temperature, invalid=invalid,
            force_full_length=force_full_length)
        gen_codes[:, g] = torch.where(done, 0, tok).to(torch.int32)
        write_pos = p_lens + g        # the audio position is the cache row
        step_bias = torch.where(kk <= write_pos[:, None], 0.0,
                                M.NEG_INF)[:, None, None, :]
        hidden_s = decoder_stack_decode_step(
            dec, ar_step_input(model, tok, write_pos, pe, dtype), cache,
            write_pos, step_bias, cross_bias, activation=cfg.activation,
            dtype=dtype)
        logits = (hidden_s[:, 0] @ W.T).float()
    check_draws(invalid, "vallf_ar_decode")
    return gen_codes, gen_lens


@torch.no_grad()
def valle_nar_decode(model: VALLE, text, text_lens, prompt_codes,
                     prompt_lens, gen_q0, gen_lens, *,
                     compute_dtype=torch.float32, score_bf16: bool = False,
                     attn_impl: str = "einsum") -> torch.Tensor:
    """Q-1 sequential NAR argmax passes. Returns codes (B, G, Q) int32.

    Sequence layout [text(S); prompt(P); generated(G)] with per-sample
    padding masks (VALL-F: [prompt; generated], the text the
    cross-attention memory); PE positions are prompt 0..P-1 and generated
    p..p+g-1. With prenets, the NAR audio prenet applies to the summed
    embeddings every pass. ``attn_impl="flash"`` runs each pass's
    attention through ``ops/flash_mha.py`` with the padding mask as
    key-validity codes (VALL-E only, as in JAX).
    """
    if attn_impl not in ("einsum", "flash"):
        raise ValueError(f"attn_impl must be einsum|flash: {attn_impl!r}")
    cfg = model.cfg
    vallf = cfg.model_name == "vallf"
    if vallf and attn_impl == "flash":
        raise ValueError("VALL-F's NAR passes take attn_impl 'einsum': its "
                         "decoder stack has no flash path")
    dev = text.device
    B, S = text.shape
    P = prompt_codes.shape[1]
    G = gen_q0.shape[1]
    Q = cfg.num_quantizers
    dtype = compute_dtype
    x_lens = text_lens.to(dev, torch.int64)
    p_lens = prompt_lens.to(dev, torch.int64)
    g_lens = gen_lens.to(dev, torch.int64)

    pe_n = pe_table(cfg, cfg.nar_d_model, device=dev)
    embs = [e.word_embeddings.weight for e in model.nar_audio_embeddings]
    x = text_frontend(model, "nar", text, dtype)

    prompt_valid = torch.arange(P, device=dev)[None, :] < p_lens[:, None]
    gen_valid = torch.arange(G, device=dev)[None, :] < g_lens[:, None]
    pc = prompt_codes.to(dev).long() * prompt_valid[..., None]
    g0 = gen_q0.to(dev).long() * gen_valid

    y_emb_p = token_embedding(embs[0], pc[..., 0], dtype)
    y_emb_g = token_embedding(embs[0], g0, dtype)
    if cfg.prefix_mode != 0:
        # all prompt quantizers summed up-front (reference valle.py:1110)
        for j in range(1, Q):
            y_emb_p = y_emb_p + token_embedding(embs[j], pc[..., j], dtype)

    Sx = 0 if vallf else S       # VALL-F: the text is not in the sequence
    kk = torch.arange(Sx + P + G, device=dev)[None, :]
    key_valid = torch.where(
        kk < Sx, kk < x_lens[:, None],
        torch.where(kk < Sx + P, (kk - Sx) < p_lens[:, None],
                    (kk - Sx - P) < g_lens[:, None]))
    cross_bias = M.key_padding_bias(x_lens, S) if vallf else None
    fspec, bias = None, None
    if attn_impl == "flash":
        qc, kc = M.flash_codes_key_valid(key_valid)
        fspec = {"qcode": qc, "kcode": kc}
    else:
        bias = torch.zeros(key_valid.shape, device=dev)
        bias.masked_fill_(~key_valid, M.NEG_INF)
        bias = bias[:, None, None, :]

    pe_p = pe_n[:P].to(dtype)
    pos_g = p_lens[:, None] + torch.arange(G, device=dev)[None, :]
    pe_g = pe_n[pos_g.clamp(0, cfg.max_len - 1)].to(dtype)

    W = nar_predict_weights(model)                    # (Q-1, V, nd)
    codes_out = torch.zeros(B, G, Q, dtype=torch.int32, device=dev)
    codes_out[..., 0] = g0.to(torch.int32)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for i in range(Q - 1):
        cond = model.nar_stage_embeddings[i].word_embeddings.weight  # (1, nd)
        py_p, py_g = y_emb_p, y_emb_g
        if cfg.add_prenet:
            # the reference's NAR audio prenet on the summed embedding,
            # every pass (valle.py:1117-1121)
            py_p = audio_prenet(model.nar_audio_prenet, py_p)
            py_g = audio_prenet(model.nar_audio_prenet, py_g)
        audio = [py_p + pe_p, py_g + pe_g]
        if vallf:
            hid = decoder_stack_apply(
                model.nar_decoder, torch.cat(audio, dim=1), x, bias,
                cross_bias, cond, activation=cfg.activation, dtype=dtype,
                score_bf16=score_bf16)
        else:
            hid = encoder_stack_apply(
                model.nar_decoder, torch.cat([x] + audio, dim=1), bias, cond,
                activation=cfg.activation, dtype=dtype,
                score_bf16=score_bf16, flash_spec=fspec)
        logits = hid[:, -G:] @ W[i].to(dtype).T              # (B, G, V)
        samples = logits.argmax(dim=-1)
        codes_out[..., i + 1] = (samples * gen_valid).to(torch.int32)
        if i < Q - 2:
            emb_next = token_embedding(embs[i + 1], samples, dtype)
            y_emb_g = y_emb_g + torch.where(gen_valid[..., None], emb_next,
                                            zero)
            if cfg.prefix_mode == 0:
                # prompt quantizer i+1 added after pass i (reference 1104)
                emb_pn = token_embedding(embs[i + 1], pc[..., i + 1], dtype)
                y_emb_p = y_emb_p + torch.where(prompt_valid[..., None],
                                                emb_pn, zero)
    return codes_out


def trim_enrolled_text(text, text_lens, enroll_x_lens):
    """Cut enrolled phonemes for NAR in prefix modes 2/4 (static shapes):
    text' = [text[:1], text[enroll_len-1:]]. Returns (text', new_lens)."""
    B, S = text.shape
    e = enroll_x_lens.to(text.device, torch.int64)[:, None]
    i = torch.arange(S, device=text.device)[None, :]
    src = torch.where(i == 0, 0, torch.clamp(i + e - 2, 0, S - 1))
    out = torch.gather(text, 1, src.expand(B, S))
    new_lens = text_lens.to(text.device, torch.int64) - (e[:, 0] - 2)
    return out, new_lens


def resolve_auto_decode_mode(*, B: int, S: int, P: int, max_gen_len: int,
                             head_dim: int) -> str:
    """The JAX package's policy: fused_w8 at B <= 4, int8 for long caches
    at B % 8 == 0, fused otherwise. Its thresholds were measured on a TPU
    and wait to be measured again on the H100. int8 is picked only where
    its kernel takes the head dim (``DECODE_HEAD_DIMS``)."""
    from ..ops.decode_attention_kv import DECODE_HEAD_DIMS

    cache = S + P + max_gen_len + 2
    if B <= 4:
        return "fused_w8"
    if cache >= 640 and B % 8 == 0 and head_dim in DECODE_HEAD_DIMS:
        return "int8"
    return "fused"


def resolve_decode_mode(mode: str, cfg, *, B: int, S: int, P: int,
                        max_gen_len: int) -> str:
    """The decode mode that will run for a batch of B rows; resolving a
    resolved mode returns it unchanged.

    - ``auto`` becomes ``resolve_auto_decode_mode``'s pick.
    - The JAX package's mode rule: its attention-kernel modes group rows
      by 8, and at B % 8 != 0 it runs "int8", "bf16" and "lanes" on the
      exact path, "fused_int8", "fused_kv", "fused_lanes" and "mega" as
      "fused", and "grouped" as "per_sample" (``UNGROUPED_MODES``). The
      port keeps the rule so that its results equal JAX's; its own
      kernels take any B.
    - The fused modes need d_model % 128 == 0 and raise otherwise, and an
      unknown mode raises: apart from the rule above, no mode quietly
      takes another.
    - VALL-F has one decode path, the plain one: every mode resolves to
      "exact" for it, as JAX's ``valle_inference`` ignores the mode there.
    - Post-norm stacks resolve as pre-norm ones, as in JAX; their decode
      step then refuses the fused modes (ROADMAP C12).
    """
    from ..ops.fused_dense import fused_dense_supported

    if mode not in AR_DECODE_MODES + ("auto",):
        raise ValueError(f"unknown decode mode {mode!r} (one of "
                         f"{AR_DECODE_MODES} or 'auto')")
    if cfg.model_name == "vallf":
        return "exact"
    if mode == "auto":
        mode = resolve_auto_decode_mode(B=B, S=S, P=P,
                                        max_gen_len=max_gen_len,
                                        head_dim=cfg.d_model // cfg.nhead)
    if B % 8 != 0:
        mode = UNGROUPED_MODES.get(mode, mode)
    if mode in FUSED_MODES and not fused_dense_supported(
            cfg.d_model, 4 * cfg.d_model):
        raise ValueError(f"decode mode {mode!r} needs d_model % 128 == 0")
    return mode


def valle_inference(model: VALLE, text, text_lens, prompt_codes, prompt_lens,
                    enroll_x_lens=None, *, top_k: int = -100,
                    temperature: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    max_gen_len: int = 1024, compute_dtype=torch.float32,
                    decode_mode: str = "exact", nar_score_bf16: bool = False,
                    nar_attn_impl: str = "einsum"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full zero-shot synthesis: AR decode then NAR refinement.

    ``decode_mode``: "exact"/"unroll" (plain path), "fused" (the
    ``fused_ln_qkv``/``fused_tail`` kernels), "fused_w8" (the same over
    int8 weights, quantized once per call); attention kernels over their
    own caches: "int8" (int8 cache, plain dense path), "bf16" and "lanes"
    (cache in the compute dtype, plain dense path), "fused_int8",
    "fused_kv" and "fused_lanes" (the same with the fused dense kernels),
    "mega" (``fused_ln_qkv`` + ``fused_attn_tail``); or "auto". At fp32
    every mode but "fused_w8", "int8" and "fused_int8" gives the exact
    path's greedy tokens. ``resolve_decode_mode`` says which mode runs.
    "grouped" and "per_sample" are ``valle_ar_decode``'s alone, as in the
    JAX package. VALL-F runs ``vallf_ar_decode`` whatever the mode, and
    its NAR passes on the einsum path (JAX's dispatch). Returns (codes (B,
    max_gen_len, Q) int32, gen_lens (B,) int32).
    """
    if decode_mode not in DECODE_MODES + ("auto",):
        raise ValueError(f"valle_inference: decode mode {decode_mode!r} is "
                         f"not one of {DECODE_MODES} or 'auto'")
    kw = dict(generator=generator, top_k=top_k, temperature=temperature,
              max_gen_len=max_gen_len, compute_dtype=compute_dtype)
    if model.cfg.model_name == "vallf":
        gen_q0, gen_lens = vallf_ar_decode(
            model, text, text_lens, prompt_codes[..., 0], prompt_lens, **kw)
    else:
        gen_q0, gen_lens = valle_ar_decode(
            model, text, text_lens, prompt_codes[..., 0], prompt_lens,
            decode_mode=decode_mode, **kw)
    codes = valle_nar_finish(
        model, text, text_lens, prompt_codes, prompt_lens, gen_q0, gen_lens,
        enroll_x_lens, compute_dtype=compute_dtype,
        nar_score_bf16=nar_score_bf16, nar_attn_impl=nar_attn_impl)
    return codes, gen_lens


def valle_nar_finish(model: VALLE, text, text_lens, prompt_codes,
                     prompt_lens, gen_q0, gen_lens, enroll_x_lens=None, *,
                     compute_dtype=torch.float32,
                     nar_score_bf16: bool = False,
                     nar_attn_impl: str = "einsum") -> torch.Tensor:
    """The NAR side of ``valle_inference`` after an AR decode: the AR
    codes alone at one quantizer, else the Q-1 NAR passes, the enrolled
    phonemes cut from their text in prefix modes 2/4 when
    ``enroll_x_lens`` is given. Returns codes (B, G, Q) int32."""
    cfg = model.cfg
    if cfg.num_quantizers == 1:
        return gen_q0[..., None]
    if cfg.prefix_mode in (2, 4) and enroll_x_lens is not None:
        text, text_lens = trim_enrolled_text(text, text_lens, enroll_x_lens)
    return valle_nar_decode(
        model, text, text_lens, prompt_codes, prompt_lens, gen_q0, gen_lens,
        compute_dtype=compute_dtype, score_bf16=nar_score_bf16,
        attn_impl="einsum" if cfg.model_name == "vallf" else nar_attn_impl)


@torch.no_grad()
def valle_continual(model: VALLE, text, text_lens, y, y_lens, *,
                    compute_dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codec resynthesis (valle_tpu/models/inference.py:813): keep
    quantizer 0 of an utterance's codes ``y`` (B, T, Q) past a prefix of
    ``min(int(min(y_lens) * 0.5), 225)`` frames and regenerate quantizers
    1..Q-1 with the NAR passes (einsum attention), the prefix frames as
    the acoustic prompt. Row t of the returned codes (B, T, Q) is frame
    prefix + t; rows past ``out_lens = y_lens - prefix`` are zeros.
    Returns (codes, out_lens int32)."""
    cfg = model.cfg
    dev = text.device
    B, T, _ = y.shape
    y = y.to(dev, torch.int64)
    y_lens = y_lens.to(dev, torch.int64)
    prefix_len = min(int(int(y_lens.min()) * 0.5), 3 * 75)
    pos = torch.arange(T, device=dev)[None, :]
    valid = pos < y_lens[:, None]
    prompt_codes = y * (pos < prefix_len)[..., None]
    # generated frames start at the prefix: shift quantizer 0 left by it
    idx = torch.clamp(pos + prefix_len, 0, T - 1).expand(B, T)
    gen_q0 = torch.gather(y[..., 0] * valid, 1, idx)
    gen_lens = y_lens - prefix_len
    codes = valle_nar_decode(
        model, text, text_lens, prompt_codes[:, : cfg.max_prefix_len],
        torch.full((B,), prefix_len, dtype=torch.int64, device=dev),
        gen_q0, gen_lens, compute_dtype=compute_dtype)
    return codes, gen_lens.to(torch.int32)
