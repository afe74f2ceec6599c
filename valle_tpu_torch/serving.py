"""Batched zero-shot TTS serving (mirror of ``valle_tpu/serving.py``).

``Synthesizer`` pads text to multiples of 16, prompts to multiples of 32
and the batch to the 1/2/4/8/16/24... grid, runs ``valle_inference`` once
per batch on its device, and decodes the codes to 24 kHz audio.
``ContinuousBatcher`` keeps a fixed table of decode slots and refills a
slot as soon as its request finishes (``models/cb_decode.py``). A
request's prompt is precomputed codes or a wav, which the codec encodes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
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


class RequestError(ValueError):
    """A request that cannot be served as it is, found while preparing it
    alone: ``http_status`` 413 for text longer than the engine's text
    width, 400 for a prompt that cannot be read or codes or text outside
    the model's vocabularies."""

    def __init__(self, msg: str, http_status: int = 400):
        super().__init__(msg)
        self.http_status = http_status


@dataclasses.dataclass
class PreparedRequest:
    """A request tokenized and its prompt encoded (an engine's
    ``prepare``): what the engines take in place of a SynthesisRequest."""
    tokens: List[str]
    enroll: int               # enrolled prompt phonemes + 2
    prompt_codes: np.ndarray  # (P, Q) int32


def _prep_request(text_tokenizer, text_collater, audio_tokenizer,
                  r: "SynthesisRequest", cfg) -> PreparedRequest:
    """Tokenize prompt_text+text together; enroll length is
    len(prompt phonemes)+2 (a bare 2 without prompt text); prompt codes
    from precomputed codes, a wav through the codec, or empty. Raises
    ``RequestError`` for a symbol outside the text table, codes of another
    shape or outside 0..num_audio_tokens-1, or a wav that cannot be
    read."""
    from .data.tokenizer import tokenize_audio, tokenize_text

    if isinstance(r, PreparedRequest):
        return r
    toks = tokenize_text(text_tokenizer, f"{r.prompt_text} {r.text}".strip())
    missing = sorted({t for t in toks if t not in text_collater.token2idx})
    if missing:
        raise RequestError(f"text symbols not in the table: {missing[:5]}")
    enroll = (len(tokenize_text(text_tokenizer, r.prompt_text)) + 2
              if r.prompt_text else 2)
    Q = cfg.num_quantizers
    if r.prompt_codes is not None:
        pc = np.asarray(r.prompt_codes, np.int32)
        if pc.ndim != 2 or pc.shape[1] != Q or (pc.size and not (
                0 <= pc.min() and pc.max() < cfg.num_audio_tokens)):
            raise RequestError(
                f"prompt_codes must be (frames, {Q}) in 0.."
                f"{cfg.num_audio_tokens - 1}: shape {pc.shape}")
    elif r.prompt_wav:
        try:
            pc = tokenize_audio(audio_tokenizer, r.prompt_wav)[0]
        except (OSError, ValueError) as e:
            raise RequestError(f"prompt_wav {r.prompt_wav!r} cannot be "
                               f"read: {e}") from e
    else:
        pc = np.zeros((0, Q), np.int32)
    return PreparedRequest(toks, enroll, pc)


def _results(audio_tokenizer, codes, gen_lens, n: int, codec_dtype: str,
             wav_transfer: str) -> List[SynthesisResult]:
    """The first n rows of a padded batch: codes (B, G, Q) and lengths
    decoded to 24 kHz audio, each cut to its frames."""
    wavs = audio_tokenizer.decode(codes, dtype=codec_dtype,
                                  transfer=wav_transfer)[:n]
    codes = torch.as_tensor(codes).cpu().numpy()[:n]
    gen_lens = torch.as_tensor(gen_lens).cpu().numpy()[:n]
    out = []
    for i in range(n):
        f = int(gen_lens[i])
        out.append(SynthesisResult(wav=wavs[i, : f * 320], codes=codes[i, :f],
                                   frames=f))
    return out


def _on_device(device):
    """Make ``device`` current in the calling thread when it is a card (a
    serving worker runs the engine on its own thread)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Synthesizer:
    """End-to-end batched synthesis: text + prompt codes -> wav.

    ``model`` is a ``models.valle.VALLE`` on ``device``; weights are cast
    to ``compute_dtype`` at use (cast the model beforehand to avoid the
    per-call copies). ``decode_mode`` is any mode of
    ``models.inference.valle_inference`` or "auto"; each batch resolves
    it (``resolve_decode_mode``) from its padded shape, and
    ``last_decode_mode`` holds the mode the last batch ran ("exact" for
    VALL-F, whose one decode path ignores the mode, as in JAX).
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

    def prepare(self, r) -> PreparedRequest:
        """Tokenize one request and encode its prompt (``RequestError``
        for one that cannot be served): a server prepares each request
        alone, so that a bad one fails no other."""
        with torch.no_grad(), _on_device(self.device):
            return _prep_request(self.text_tokenizer, self.text_collater,
                                 self.audio_tokenizer, r, self.model.cfg)

    def _prepare(self, reqs):
        preps = [self.prepare(r) for r in reqs]
        token_seqs = [p.tokens for p in preps]
        enroll_lens = [p.enroll for p in preps]
        prompt_codes = [p.prompt_codes for p in preps]
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
        return _results(self.audio_tokenizer, codes, gen_lens, B,
                        self.codec_dtype, self.wav_transfer)


class ContinuousBatcher:
    """Continuous-batching serving loop (mirror of
    ``valle_tpu/serving.py:412``): a fixed table of ``slots`` decode lanes;
    whenever lanes finish, the next queued requests are prefilled at the
    fixed width ``slots`` and installed into them mid-flight
    (``models/cb_decode.py``). Finished AR sequences are refined in NAR
    groups of ``slots`` and decoded to 24 kHz audio, so under greedy
    decoding each result is the Synthesizer's.

    ``model`` is a ``models.valle.VALLE`` on ``device`` (cast it to
    ``compute_dtype`` beforehand to avoid per-call weight copies). Every
    request is padded to ``text_pad`` text tokens (longer text raises
    ``RequestError``, a ``ValueError``, in ``prepare``) and its prompt cut
    to ``prompt_pad`` frames. ``admission`` "lpt" admits the longest text
    (largest 16x budget) first, "fifo" in submission order; results return
    in submission order either way. ``last_stats`` holds the last run's
    chunks, waves, decode steps run (``steps``) and those the host planned
    (``steps_planned``: each chunk's K, cut by the lanes' caps), and the
    seconds of its refill waves (``install_s``: prefill + install) and of
    its chunks (``decode_s``), each synchronized with the device.
    ``mesh`` (serving over several cards, ROADMAP A12.1) is not ported.
    The prenets' statistics are the model's own buffers (JAX passes them
    as ``model_state``). VALL-F is refused, as in JAX: the CB step is
    VALL-E's.
    """

    def __init__(self, model, text_tokenizer, text_collater,
                 audio_tokenizer, *, slots: int = 8, text_pad: int = 64,
                 prompt_pad: int = 256, max_gen_len: int = 512,
                 chunk: int = 64, top_k: int = -100,
                 temperature: float = 1.0, compute_dtype=torch.bfloat16,
                 seed: int = 0,
                 codec_dtype: Optional[str] = None, admission: str = "lpt",
                 nar_score_bf16="auto", nar_attn_impl: str = "auto",
                 wav_transfer: str = "pcm16", mesh=None, device="cuda"):
        cfg = model.cfg
        if cfg.model_name != "valle":
            raise ValueError("continuous batching targets VALLE")
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousBatcher(mesh=...): serving over several cards is "
                "not ported yet (ROADMAP A12.1)")
        if admission not in ("lpt", "fifo"):
            raise ValueError(f"admission must be 'lpt'|'fifo': {admission}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ContinuousBatcher(device='cuda'): no CUDA "
                               "device is available (pass device='cpu')")
        self.model = model
        self.text_tokenizer = text_tokenizer
        self.text_collater = text_collater
        self.audio_tokenizer = audio_tokenizer
        self.slots = slots
        self.text_pad = text_pad
        self.prompt_pad = prompt_pad
        self.max_gen_len = max_gen_len
        self.chunk = chunk
        self.top_k = top_k
        self.temperature = temperature
        self.compute_dtype = compute_dtype
        self.codec_dtype = codec_dtype or "bfloat16"
        self.nar_score_bf16 = resolve_nar_score_bf16(nar_score_bf16,
                                                     compute_dtype)
        # NAR groups run at width `slots`: resolved once
        self.nar_attn_impl = resolve_nar_attn_impl(
            nar_attn_impl, slots, cfg.model_name, self.device,
            head_dim=cfg.nar_d_model // cfg.nar_nhead)
        self.wav_transfer = wav_transfer
        self.admission = admission
        self.cache_len = (text_pad + int(cfg.prepend_bos) + prompt_pad
                          + max_gen_len + 1)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.last_stats: Optional[dict] = None

    def prepare(self, r) -> PreparedRequest:
        """Tokenize one request and encode its prompt; ``RequestError``
        (413) when its text does not fit ``text_pad``. A server prepares
        each request alone, so that a bad one fails no other."""
        with torch.no_grad(), _on_device(self.device):
            p = _prep_request(self.text_tokenizer, self.text_collater,
                              self.audio_tokenizer, r, self.model.cfg)
        if len(p.tokens) + 2 > self.text_pad:
            raise RequestError(
                f"text ({len(p.tokens)} tokens) exceeds text_pad="
                f"{self.text_pad}; raise text_pad", 413)
        return p

    def _prep_one(self, r):
        """A request's slot record: text padded to ``text_pad``, prompt
        cut and padded to ``prompt_pad``."""
        p = self.prepare(r)
        text_ids, text_lens = self.text_collater.index(
            [p.tokens], pad_to=self.text_pad)
        # the slot table's prompt axis is fixed: long prompts are cut
        pc = p.prompt_codes[: self.prompt_pad]
        prompts = np.zeros((1, self.prompt_pad, pc.shape[1]), np.int32)
        prompts[0, : pc.shape[0]] = pc
        return {"text": np.asarray(text_ids, np.int32),
                "text_len": int(text_lens[0]), "prompts": prompts,
                "p_len": pc.shape[0], "enroll_len": p.enroll}

    def _last_step(self, rec) -> int:
        """The step g at which a lane must stop: its 16x cap or the
        budget."""
        bos = int(self.model.cfg.prepend_bos)
        return min(self.max_gen_len, max(0, 16 * rec["text_len"] - bos + 1))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, reqs: Sequence[SynthesisRequest],
            progress: bool = False) -> List[SynthesisResult]:
        """Serve every request through the slot table; results in
        submission order."""
        if not reqs:
            return []
        with torch.no_grad(), _on_device(self.device):
            return self._run(reqs, progress)

    def _run(self, reqs, progress):
        from .models.cb_decode import (cb_decode_chunk, cb_install_many,
                                       cb_prefill, cb_state_init)

        cfg = self.model.cfg
        bos = int(cfg.prepend_bos)
        dev = self.device
        queue = [(i, self._prep_one(r)) for i, r in enumerate(reqs)]
        if self.admission == "lpt":
            # longest text first; submission order within a length
            queue.sort(key=lambda e: (-e[1]["text_len"], e[0]))
        queue.reverse()                      # pop() serves in plan order
        st = cb_state_init(cfg, slots=self.slots, cache_len=self.cache_len,
                           max_gen_len=self.max_gen_len, device=dev,
                           compute_dtype=self.compute_dtype)
        occupant = [None] * self.slots       # queue entry per slot
        steps = [0] * self.slots             # steps since its install
        finished = {}                        # req idx -> (q0, n, rec)
        stats = {"chunks": 0, "waves": 0, "steps": 0, "steps_planned": 0,
                 "install_s": 0.0, "decode_s": 0.0}

        def refill(free_slots):
            """Install up to len(free_slots) queued requests with one
            prefill and one install, the wave padded to the width
            ``slots`` by repeating entry 0 (cb_install_many's contract)."""
            take = min(len(free_slots), len(queue))
            if take == 0:
                return
            t0 = time.perf_counter()
            stats["waves"] += 1
            wave = [(free_slots[j], queue.pop()) for j in range(take)]
            for slot, entry in wave:
                occupant[slot] = entry
                steps[slot] = 0
            wave = wave + [wave[0]] * (self.slots - take)
            recs = [entry[1] for _, entry in wave]

            def col(key):
                return torch.as_tensor([r[key] for r in recs],
                                       dtype=torch.int32, device=dev)

            text = torch.as_tensor(np.concatenate([r["text"] for r in recs]),
                                   device=dev)
            q0 = torch.as_tensor(np.concatenate(
                [r["prompts"][..., 0] for r in recs]), device=dev)
            text_lens, p_lens = col("text_len"), col("p_len")
            kb, vb, lg0 = cb_prefill(
                self.model, text, text_lens, q0, p_lens,
                cache_len=self.cache_len, compute_dtype=self.compute_dtype)
            cb_install_many(st, [s for s, _ in wave], kb, vb, lg0,
                            text_lens, p_lens + bos)
            self._sync()
            stats["install_s"] += time.perf_counter() - t0

        refill(list(range(self.slots)))
        while any(o is not None for o in occupant):
            # no more steps than the longest live lane can still take
            left = max(self._last_step(occupant[s][1]) + 1 - steps[s]
                       for s in range(self.slots) if occupant[s] is not None)
            K = max(1, min(self.chunk, left))
            t0 = time.perf_counter()
            n = cb_decode_chunk(
                self.model, st, self.temperature, S=self.text_pad, K=K,
                top_k=self.top_k, generator=self.generator,
                compute_dtype=self.compute_dtype)
            done = st["done"].cpu().numpy()  # the chunk has synchronized
            stats["decode_s"] += time.perf_counter() - t0
            stats["chunks"] += 1
            stats["steps"] += n
            stats["steps_planned"] += K
            for s in range(self.slots):
                steps[s] += n
            freed = [s for s in range(self.slots)
                     if occupant[s] is not None and done[s]]
            if not freed:
                continue
            gen_codes = st["gen_codes"].cpu().numpy()
            gen_lens = st["gen_lens"].cpu().numpy()
            for slot in freed:
                idx, rec = occupant[slot]
                finished[idx] = (gen_codes[slot].copy(),
                                 int(gen_lens[slot]), rec)
                occupant[slot] = None
            refill(freed)
            if progress:
                logging.info("continuous: %d/%d finished, %d queued",
                             len(finished), len(reqs), len(queue))
        # stamped before the NAR finishing, which has its own profile
        self.last_stats = dict(stats)
        return self._finalize(finished)

    def _finalize(self, finished) -> List[SynthesisResult]:
        """NAR passes in groups of ``slots`` (padded by repeating row 0),
        then the codec."""
        from .models.inference import valle_nar_finish

        dev = self.device
        order = sorted(finished)
        results = []
        for lo in range(0, len(order), self.slots):
            idxs = order[lo: lo + self.slots]
            rows = idxs + [idxs[0]] * (self.slots - len(idxs))
            recs = [finished[i][2] for i in rows]

            def stack(key):
                return torch.as_tensor(np.asarray(
                    [r[key] for r in recs], np.int32), device=dev)

            gen_lens = torch.as_tensor(np.asarray(
                [finished[i][1] for i in rows], np.int32), device=dev)
            codes = valle_nar_finish(
                self.model,
                torch.as_tensor(np.concatenate([r["text"] for r in recs]),
                                device=dev),
                stack("text_len"),
                torch.as_tensor(np.concatenate([r["prompts"] for r in recs]),
                                device=dev),
                stack("p_len"),
                torch.as_tensor(np.stack([finished[i][0] for i in rows]),
                                device=dev),
                gen_lens, stack("enroll_len"),
                compute_dtype=self.compute_dtype,
                nar_score_bf16=self.nar_score_bf16,
                nar_attn_impl=self.nar_attn_impl)
            results += _results(self.audio_tokenizer, codes, gen_lens,
                                len(idxs), self.codec_dtype,
                                self.wav_transfer)
        return results
