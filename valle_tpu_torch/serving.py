"""Batched zero-shot TTS serving (mirror of ``valle_tpu/serving.py``).

``Synthesizer`` pads text to multiples of 16, prompts to multiples of 32
and the batch to the 1/2/4/8/16/24... grid, runs ``valle_inference`` once
per batch on its device, and decodes the codes to 24 kHz audio. A
request's prompt is precomputed codes or a wav, which the codec encodes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class SynthesisRequest:
    text: str
    prompt_text: str = ""
    prompt_wav: Optional[str] = None           # path
    prompt_codes: Optional[np.ndarray] = None  # (P, Q) precomputed


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray          # (T,) float32 @ 24 kHz
    codes: np.ndarray        # (F, Q)
    frames: int


def resolve_nar_score_bf16(mode, compute_dtype) -> bool:
    """"auto" stores NAR scores in bf16 whenever compute is bf16 (inert at
    fp32). Accepts bools."""
    if isinstance(mode, bool):
        return mode
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"nar_score_bf16 must be 'auto'|'on'|'off'|bool: {mode!r}")
    if mode == "auto":
        return compute_dtype == torch.bfloat16
    return mode == "on"


def resolve_nar_attn_impl(mode: str, B: int, model_name: str = "valle",
                          device="cuda", *, head_dim: int) -> str:
    """"auto": the flash kernel at B <= 8 on CUDA where it takes the NAR
    head dim (``nar_d_model // nar_nhead``; ``FLASH_HEAD_DIMS``), einsum
    above it, at other head dims and on the CPU. The B <= 8 threshold was
    measured on a TPU and waits to be measured again on the H100."""
    from .ops.flash_mha import FLASH_HEAD_DIMS

    if mode in ("einsum", "flash"):
        return mode
    if mode != "auto":
        raise ValueError(f"nar_attn_impl must be auto|einsum|flash: {mode}")
    if (model_name == "vallf" or torch.device(device).type != "cuda"
            or head_dim not in FLASH_HEAD_DIMS):
        return "einsum"
    return "flash" if B <= 8 else "einsum"


def plan_groups(reqs: Sequence["SynthesisRequest"],
                group_size: int) -> List[List[int]]:
    """Indices sorted by prompt_text+text length, longest first, split
    into ``group_size`` batches (the 16x decode budget tracks a batch's
    longest request)."""
    order = sorted(range(len(reqs)),
                   key=lambda i: len(reqs[i].prompt_text) + len(reqs[i].text),
                   reverse=True)
    return [order[lo: lo + group_size]
            for lo in range(0, len(order), group_size)]


def _prep_request(text_tokenizer, audio_tokenizer, r: "SynthesisRequest",
                  num_quantizers: int):
    """Tokenize prompt_text+text together; enroll length is
    len(prompt phonemes)+2 (a bare 2 without prompt text); prompt codes
    from precomputed codes, a wav through the codec, or empty. Returns
    (tokens, enroll, codes)."""
    from .data.tokenizer import tokenize_audio, tokenize_text

    toks = tokenize_text(text_tokenizer, f"{r.prompt_text} {r.text}".strip())
    enroll = (len(tokenize_text(text_tokenizer, r.prompt_text)) + 2
              if r.prompt_text else 2)
    if r.prompt_codes is not None:
        pc = np.asarray(r.prompt_codes, np.int32)
    elif r.prompt_wav:
        pc = tokenize_audio(audio_tokenizer, r.prompt_wav)[0]
    else:
        pc = np.zeros((0, num_quantizers), np.int32)
    return toks, enroll, pc


class Synthesizer:
    """End-to-end batched synthesis: text + prompt codes -> wav.

    ``model`` is a ``models.valle.VALLE`` on ``device``; weights are cast
    to ``compute_dtype`` at use (cast the model beforehand to avoid the
    per-call copies). ``decode_mode`` is any mode of
    ``models.inference.valle_inference`` or "auto"; each batch resolves
    it (``resolve_decode_mode``) from its padded shape, and
    ``last_decode_mode`` holds the mode the last batch ran.
    """

    def __init__(self, model, text_tokenizer, text_collater,
                 audio_tokenizer, *, top_k: int = -100,
                 temperature: float = 1.0, max_gen_len: int = 1024,
                 compute_dtype=torch.bfloat16, seed: int = 0,
                 decode_mode: str = "exact",
                 codec_dtype: Optional[str] = None,
                 nar_score_bf16="auto", nar_attn_impl: str = "auto",
                 wav_transfer: str = "pcm16", device="cuda"):
        self.model = model
        self.text_tokenizer = text_tokenizer
        self.text_collater = text_collater
        self.audio_tokenizer = audio_tokenizer
        self.top_k = top_k
        self.temperature = temperature
        self.max_gen_len = max_gen_len
        self.compute_dtype = compute_dtype
        self.decode_mode = decode_mode
        self.codec_dtype = codec_dtype or "bfloat16"
        self.nar_score_bf16 = resolve_nar_score_bf16(nar_score_bf16,
                                                     compute_dtype)
        self.nar_attn_impl = nar_attn_impl
        self.wav_transfer = wav_transfer
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.last_decode_mode: Optional[str] = None

    @classmethod
    def from_checkpoint(cls, checkpoint: str, text_tokens: Optional[str],
                        text_backend: str = "espeak",
                        encodec_weights: Optional[str] = None, *,
                        device="cuda", **kw):
        """A Synthesizer over a reference-format ``.pt`` checkpoint
        (``models.load_model``); a ``text_tokens`` of None takes the
        symbol table the checkpoint names."""
        from .data.collation import get_text_token_collater
        from .data.tokenizer import AudioTokenizer, TextTokenizer
        from .models import load_model

        model, ckpt_tokens = load_model(checkpoint, device=device)
        return cls(model, TextTokenizer(backend=text_backend),
                   get_text_token_collater(text_tokens or ckpt_tokens),
                   AudioTokenizer(weights_path=encodec_weights,
                                  device=device),
                   device=device, **kw)

    def _prepare(self, reqs: Sequence[SynthesisRequest]):
        token_seqs, enroll_lens, prompt_codes = [], [], []
        for r in reqs:
            toks, enroll, pc = _prep_request(
                self.text_tokenizer, self.audio_tokenizer, r,
                self.model.cfg.num_quantizers)
            token_seqs.append(toks)
            enroll_lens.append(enroll)
            prompt_codes.append(pc)
        max_tok = max(len(t) for t in token_seqs) + 2
        text_ids, text_lens = self.text_collater.index(
            token_seqs, pad_to=_round_up(max_tok, 16))
        P = _round_up(max(max(c.shape[0] for c in prompt_codes), 1), 32)
        Q = self.model.cfg.num_quantizers
        prompts = np.zeros((len(reqs), P, Q), np.int32)
        p_lens = np.zeros((len(reqs),), np.int32)
        for i, c in enumerate(prompt_codes):
            prompts[i, : c.shape[0]] = c
            p_lens[i] = c.shape[0]
        return (text_ids, text_lens, prompts, p_lens,
                np.asarray(enroll_lens, np.int32))

    def synthesize(self, reqs: Sequence[SynthesisRequest],
                   max_gen_len: Optional[int] = None
                   ) -> List[SynthesisResult]:
        from .models.inference import resolve_decode_mode, valle_inference

        if not reqs:
            return []
        batch = list(self._prepare(reqs))
        text_lens = batch[1]
        gen_budget = max_gen_len or min(
            self.max_gen_len, _round_up(int(text_lens.max()) * 16 + 2, 64))
        # snap the batch to the 1/2/4/8/16/24... grid; pad rows repeat
        # request 0 and are trimmed below
        B = len(reqs)
        Bp = 1 << (B - 1).bit_length() if B < 8 else _round_up(B, 8)
        if Bp != B:
            batch = [np.concatenate([a, np.repeat(a[:1], Bp - B, axis=0)])
                     for a in batch]
        text_ids, text_lens, prompts, p_lens, enroll_lens = [
            torch.as_tensor(a, device=self.device) for a in batch]
        cfg = self.model.cfg
        self.last_decode_mode = resolve_decode_mode(
            self.decode_mode, cfg, B=Bp, S=text_ids.shape[1],
            P=prompts.shape[1], max_gen_len=gen_budget)
        codes, gen_lens = valle_inference(
            self.model, text_ids, text_lens, prompts, p_lens,
            enroll_x_lens=enroll_lens, top_k=self.top_k,
            temperature=self.temperature, generator=self.generator,
            max_gen_len=gen_budget, compute_dtype=self.compute_dtype,
            decode_mode=self.last_decode_mode,
            nar_score_bf16=self.nar_score_bf16,
            nar_attn_impl=resolve_nar_attn_impl(
                self.nar_attn_impl, Bp, cfg.model_name, self.device,
                head_dim=cfg.nar_d_model // cfg.nar_nhead))
        # decode the padded batch, then trim the padding rows
        wavs = self.audio_tokenizer.decode(codes, dtype=self.codec_dtype,
                                           transfer=self.wav_transfer)[:B]
        codes = codes.cpu().numpy()[:B]
        gen_lens = gen_lens.cpu().numpy()[:B]
        out = []
        for i in range(B):
            n = int(gen_lens[i])
            out.append(SynthesisResult(wav=wavs[i, : n * 320],
                                       codes=codes[i, :n], frames=n))
        return out
