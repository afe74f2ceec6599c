"""Batched zero-shot TTS serving (mirror of ``valle_tpu/serving.py``).

``Synthesizer`` pads text to multiples of 16, prompts to multiples of 32
and the batch to the 1/2/4/8/16/24... grid, runs ``valle_inference`` once
per batch on its device, and decodes the codes to 24 kHz audio.
``ContinuousBatcher`` keeps a fixed table of decode slots and refills a
slot as soon as its request finishes (``models/cb_decode.py``). A
request's prompt is precomputed codes or a wav, which the codec encodes.

Both take a ``mesh`` (``parallel.mesh.make_mesh``) to serve over several
devices: the batch's rows, or the slot table, split into one contiguous
block a data shard, and each shard runs the whole decode program on its
block, its own model replica and its own thread, as JAX's engines run
under ``shard_map`` and GSPMD (``valle_tpu/serving.py:346,519``). The
codes meet on the mesh's first device, where the codec decodes them. A
mesh with a model axis (``tp`` > 1; the Synthesizer in "exact" and
"unroll", as JAX allows) gives each data shard ``tp`` model shards, a
thread each on its mesh device, each with its slices of the split
weights (``parallel/tensor.py``) and summing its partial products with
its data shard's other model shards.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .ops import cuda_build
from .ops.sampling import RowDraws
from .parallel.tensor import ModelShard, ThreadGroup, sharded_copies


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


# the decode modes JAX runs under shard_map on a mesh (the kernel modes),
# and those of them that group rows by 8
MESH_KERNEL_MODES = ("int8", "fused", "fused_int8", "fused_w8", "bf16",
                     "fused_kv", "lanes", "fused_lanes", "mega", "auto")
_GROUPED_MODES = ("int8", "fused_int8", "bf16", "fused_kv", "lanes",
                  "fused_lanes", "mega")
_KERNEL_TP_REFUSAL = (
    "decode_mode='{mode}' needs whole weight matrices on each device (the "
    "kernels stream full weights); with tensor parallelism use 'exact' or "
    "'unroll'. DP-only is the designed ceiling for the kernel modes at "
    "this model size")


def resolve_mesh_decode_mode(mode: str, cfg, *, B: int, S: int, P: int,
                             max_gen_len: int) -> str:
    """The decode mode each shard of a mesh runs on its ``B`` rows: JAX's
    mesh rule (``valle_tpu/serving.py:372-382``), then
    ``resolve_decode_mode``. For a kernel mode (``MESH_KERNEL_MODES``)
    "auto" resolves against the shard's rows, and at ``B % 8 != 0`` every
    mode that groups rows by 8 runs as "fused" (where one device's rule
    sends some of them to "exact"). "exact" and "unroll" stay."""
    from .models.inference import (resolve_auto_decode_mode,
                                   resolve_decode_mode)

    if mode in MESH_KERNEL_MODES:
        if mode == "auto":
            mode = resolve_auto_decode_mode(
                B=B, S=S, P=P, max_gen_len=max_gen_len,
                head_dim=cfg.d_model // cfg.nhead)
        if mode in _GROUPED_MODES and B % 8 != 0:
            mode = "fused"
    return resolve_decode_mode(mode, cfg, B=B, S=S, P=P,
                               max_gen_len=max_gen_len)


def _fold_in(seed: int, index: int) -> int:
    """A generator seed for shard ``index`` of an engine seeded ``seed``
    (the counterpart of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0])


@dataclasses.dataclass
class _Shard:
    """One shard of an engine's mesh: its device, model (a replica, or its
    model shard's slices), generator, on a card its stream, and under a
    model axis the ``ThreadGroup`` of its data shard."""
    device: torch.device
    model: torch.nn.Module
    generator: torch.Generator
    stream: Optional[torch.cuda.Stream] = None
    group: Optional[ThreadGroup] = None


class _ShardPool:
    """Runs one callable a shard, each on a thread of its own with the
    shard's device current, its stream, no autograd, and its kernel
    launches counted under its index (``cuda_build.shard_scope``); waits
    for every shard and raises the first error. One shard runs on the
    caller's thread."""

    def __init__(self, shards: List[_Shard]):
        self.shards = shards
        self.pool = (concurrent.futures.ThreadPoolExecutor(
            len(shards), thread_name_prefix="valle-shard")
            if len(shards) > 1 else None)

    def _one(self, fn: Callable, i: int):
        sh = self.shards[i]
        stream = sh.stream
        with torch.no_grad(), _on_device(sh.device), \
                cuda_build.shard_scope(i):
            try:
                if stream is None:
                    return fn(i, sh)
                # the weights and earlier results were written on the
                # device's default stream
                stream.wait_stream(torch.cuda.default_stream(sh.device))
                with torch.cuda.stream(stream):
                    out = fn(i, sh)
                stream.synchronize()
                return out
            except BaseException:
                if sh.group is not None:    # release the model shards
                    sh.group.abort()
                raise

    def map(self, fn: Callable) -> list:
        """[fn(i, shard) for every shard], run at once."""
        if self.pool is None:
            return [self._one(fn, 0)]
        futs = [self.pool.submit(self._one, fn, i)
                for i in range(len(self.shards))]
        concurrent.futures.wait(futs)
        for sh in self.shards:
            if sh.group is not None:
                sh.group.reset()
        return [f.result() for f in futs]


def _mesh_shards(mesh, model, seeds: Sequence[int]) -> List[_Shard]:
    """A shard a mesh device: ``model`` itself where it lies on that
    device, else one copy a distinct device (shards of a repeated device
    share it); a generator seeded ``seeds[i]`` (one a data shard) and, on
    a card, a stream each. Under a model axis, :func:`_tp_shards`."""
    if mesh.shape["model"] > 1:
        return _tp_shards(mesh, model, seeds)
    home = next(model.parameters()).device
    replicas = {}
    shards = []
    for dev, seed in zip(mesh.devices, seeds):
        if dev not in replicas:
            replicas[dev] = (model if dev == home
                             else copy.deepcopy(model).to(dev))
        shards.append(_Shard(
            dev, replicas[dev], torch.Generator(dev).manual_seed(seed),
            torch.cuda.Stream(dev) if dev.type == "cuda" else None))
    return shards


def _tp_shards(mesh, model, seeds: Sequence[int]) -> List[_Shard]:
    """Device ``i * tp + j`` of the mesh: a copy of ``model`` on it cut to
    model shard ``j`` (``parallel.tensor.sharded_copies``), which sums
    over the ``ThreadGroup`` of data shard ``i``; the data shard's
    generator seed ``seeds[i]``, so its model shards draw alike; a stream
    on a card."""
    tp = mesh.shape["model"]
    shards = []
    for i, seed in enumerate(seeds):
        group = ThreadGroup(tp)
        devs = mesh.devices[i * tp:(i + 1) * tp]
        models = sharded_copies(
            model, [ModelShard(tp, j, group) for j in range(tp)], devs)
        for dev, m in zip(devs, models):
            shards.append(_Shard(
                dev, m, torch.Generator(dev).manual_seed(seed),
                torch.cuda.Stream(dev) if dev.type == "cuda" else None,
                group))
    return shards


def _sync_generators(shards: List[_Shard], draws: Sequence[int]) -> None:
    """Advance every shard's generator to the state of the one that drew
    most: the state one generator drawing for the whole batch ends in."""
    far = int(np.argmax(draws))
    state = shards[far].generator.get_state()
    for sh, n in zip(shards, draws):
        if n < draws[far]:
            sh.generator.set_state(state)


class Synthesizer:
    """End-to-end batched synthesis: text + prompt codes -> wav.

    ``model`` is a ``models.valle.VALLE`` on ``device``; weights are cast
    to ``compute_dtype`` at use (cast the model beforehand to avoid the
    per-call copies). ``decode_mode`` is any mode of
    ``models.inference.valle_inference`` or "auto"; each batch resolves
    it (``resolve_decode_mode``) from its padded shape, and
    ``last_decode_mode`` holds the mode the last batch ran ("exact" for
    VALL-F, whose one decode path ignores the mode, as in JAX).

    ``mesh`` (``parallel.mesh.make_mesh``) serves each batch over its
    devices, the first of which takes ``device``'s place:
    the batch, snapped to the grid, is padded to a multiple of the data
    axis dp by repeating request 0 and split into dp blocks of Bs rows,
    and each shard runs ``valle_inference`` on its block with a replica
    of the model on its device (``_mesh_inference``). Greedy codes are
    one device's codes. Sampled codes:

    - the kernel modes (``MESH_KERNEL_MODES``) draw on each shard from a
      generator of its own, seeded from ``seed`` and the shard's index
      (JAX's ``fold_in``), so they differ from one device's draws;
    - "exact" and "unroll" (one GSPMD program in JAX, whose draws equal
      one device's) give each shard a generator seeded ``seed`` that
      draws the noise of the whole grid-snapped batch each step and keeps
      its own rows (``ops.sampling.RowDraws``); rows added for dp take
      request 0's. After a call every shard's generator takes the state
      of the one that ran the most steps, the state one device's
      generator ends in. So every call's codes equal one device's from
      the same seed and calls, provided each batch's grid-snapped size is
      a multiple of dp (with padding rows, row 0's copies there and one
      device's own padding rows may end at other steps).

    A mesh with a model axis (``tp`` > 1) runs "exact" and "unroll" only,
    as JAX's Synthesizer does (the kernel modes stream whole weights and
    raise): each of a data shard's ``tp`` model shards runs the decode
    program on the same rows with its slices of the split weights, and
    the partial products are added in shard order (``_tp_shards``), so
    fp32 results do not depend on thread timing. Greedy codes equal one
    device's, as JAX's tp2 mesh's do.
    """

    def __init__(self, model, text_tokenizer, text_collater,
                 audio_tokenizer, *, top_k: int = -100,
                 temperature: float = 1.0, max_gen_len: int = 1024,
                 compute_dtype=torch.bfloat16, seed: int = 0,
                 decode_mode: str = "exact",
                 codec_dtype: Optional[str] = None,
                 nar_score_bf16="auto", nar_attn_impl: str = "auto",
                 wav_transfer: str = "pcm16", device="cuda", mesh=None):
        self.mesh = mesh
        self._shards = None
        self._fork = decode_mode in MESH_KERNEL_MODES
        if mesh is not None:
            if mesh.shape["model"] != 1 and self._fork:
                raise ValueError(_KERNEL_TP_REFUSAL.format(mode=decode_mode))
            device = mesh.devices[0]
            self._shards = _ShardPool(_mesh_shards(
                mesh, model, [_fold_in(seed, i) if self._fork else seed
                              for i in range(mesh.shape["data"])]))
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
        if self.mesh is not None:
            codes, gen_lens = self._mesh_inference(batch, gen_budget)
            return _results(self.audio_tokenizer, codes, gen_lens, B,
                            self.codec_dtype, self.wav_transfer)
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

    def _mesh_inference(self, batch, gen_budget):
        """A grid-snapped batch (numpy arrays) over the mesh: padded to a
        multiple of dp by repeating row 0, Bs = B / dp rows a shard, the
        mode and the NAR attention resolved as JAX resolves them (per
        shard in the kernel modes, ``resolve_mesh_decode_mode``; over the
        whole batch in "exact"/"unroll"). Returns (codes, gen_lens) of
        every row on the first device."""
        from .models.inference import resolve_decode_mode, valle_inference

        cfg = self.model.cfg
        dp, tp = self.mesh.shape["data"], self.mesh.shape["model"]
        Bg = batch[0].shape[0]
        B = -(-Bg // dp) * dp
        if B != Bg:
            batch = [np.concatenate([a, np.repeat(a[:1], B - Bg, axis=0)])
                     for a in batch]
        Bs = B // dp
        S, P = batch[0].shape[1], batch[2].shape[1]
        resolve = (resolve_mesh_decode_mode if self._fork
                   else resolve_decode_mode)
        mode = resolve(self.decode_mode, cfg, B=Bs, S=S, P=P,
                       max_gen_len=gen_budget)
        self.last_decode_mode = mode
        nar = resolve_nar_attn_impl(
            self.nar_attn_impl, Bs if self._fork else B, cfg.model_name,
            self.device, head_dim=cfg.nar_d_model // cfg.nar_nhead)

        def shard(k, sh):
            i = k // tp                      # the shard's data shard
            rows = range(i * Bs, (i + 1) * Bs)
            text, tl, pr, pl, el = [
                torch.as_tensor(a[rows.start:rows.stop], device=sh.device)
                for a in batch]
            gen = (sh.generator if self._fork else RowDraws(
                sh.generator, Bg, [r if r < Bg else 0 for r in rows]))
            codes, lens = valle_inference(
                sh.model, text, tl, pr, pl, enroll_x_lens=el,
                top_k=self.top_k, temperature=self.temperature,
                generator=gen, max_gen_len=gen_budget,
                compute_dtype=self.compute_dtype, decode_mode=mode,
                nar_score_bf16=self.nar_score_bf16, nar_attn_impl=nar)
            return codes, lens, getattr(gen, "draws", 0)

        outs = self._shards.map(shard)
        if not self._fork:
            _sync_generators(self._shards.shards, [o[2] for o in outs])
        outs = outs[::tp]    # a data shard's model shards agree
        return (torch.cat([o[0].to(self.device) for o in outs]),
                torch.cat([o[1].to(self.device) for o in outs]))


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
    The prenets' statistics are the model's own buffers (JAX passes them
    as ``model_state``). VALL-F is refused, as in JAX: the CB step is
    VALL-E's.

    ``mesh`` (``parallel.mesh.make_mesh``; its first device takes
    ``device``'s place) splits the slot table into dp sub-tables of
    ``slots / dp`` lanes, one a device, each decoded by its own thread and
    model replica; ``slots % dp != 0`` and a mesh with a model axis raise
    ``ValueError``. One host scheduler and queue feed every shard: a freed
    slot is refilled on the device that owns it, a wave's requests are
    prefilled on the devices of their slots, and each NAR group of
    ``slots`` splits over the shards. Greedy and sampled results equal
    mesh=None's, as in JAX: every sub-table's generator is seeded alike,
    draws the noise of the whole table each step and keeps its own rows
    (``ops.sampling.RowDraws``), and after each chunk every generator
    takes the state of the sub-table that ran the most steps, where a
    sub-table whose lanes are all done stops early or does not run.
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
            if mesh.shape["model"] != 1:
                raise ValueError(
                    "continuous batching is DP-only: per-slot KV caches "
                    "shard over 'data'; use a (dp, 1) mesh")
            dp = mesh.shape["data"]
            if slots % dp != 0:
                raise ValueError(
                    f"slots ({slots}) must be divisible by the mesh "
                    f"data axis ({dp}): the slot table shards evenly")
            device = mesh.devices[0]
        if admission not in ("lpt", "fifo"):
            raise ValueError(f"admission must be 'lpt'|'fifo': {admission}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ContinuousBatcher(device='cuda'): no CUDA "
                               "device is available (pass device='cpu')")
        self.mesh = mesh
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
        if mesh is None:
            self._shards = None
            self._lanes = slots              # slots a sub-table
        else:
            self._shards = _ShardPool(_mesh_shards(
                mesh, model, [seed] * mesh.shape["data"]))
            self._lanes = slots // mesh.shape["data"]
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

    def _map(self, fn) -> list:
        """[fn(i, shard)] over the shards: the whole table on ``device``
        with the engine's generator without a mesh (on this thread), else
        every sub-table at once."""
        if self._shards is None:
            return [fn(0, _Shard(self.device, self.model, self.generator))]
        return self._shards.map(fn)

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
        lanes = self._lanes
        queue = [(i, self._prep_one(r)) for i, r in enumerate(reqs)]
        if self.admission == "lpt":
            # longest text first; submission order within a length
            queue.sort(key=lambda e: (-e[1]["text_len"], e[0]))
        queue.reverse()                      # pop() serves in plan order
        tables = self._map(lambda i, sh: cb_state_init(
            cfg, slots=lanes, cache_len=self.cache_len,
            max_gen_len=self.max_gen_len, device=sh.device,
            compute_dtype=self.compute_dtype))
        occupant = [None] * self.slots       # queue entry per slot
        steps = [0] * self.slots             # steps since its install
        finished = {}                        # req idx -> (q0, n, rec)
        stats = {"chunks": 0, "waves": 0, "steps": 0, "steps_planned": 0,
                 "install_s": 0.0, "decode_s": 0.0}

        def refill(free_slots):
            """Install up to len(free_slots) queued requests: on each
            sub-table that owns some of the slots, one prefill of its
            share of the wave, padded to the table's width by repeating
            its first entry (cb_install_many's contract), and one
            install."""
            take = min(len(free_slots), len(queue))
            if take == 0:
                return
            t0 = time.perf_counter()
            stats["waves"] += 1
            wave = [(free_slots[j], queue.pop()) for j in range(take)]
            for slot, entry in wave:
                occupant[slot] = entry
                steps[slot] = 0

            def install(i, sh):
                mine = [(slot - i * lanes, entry) for slot, entry in wave
                        if slot // lanes == i]
                if not mine:
                    return
                mine += [mine[0]] * (lanes - len(mine))
                recs = [entry[1] for _, entry in mine]

                def col(key):
                    return torch.as_tensor([r[key] for r in recs],
                                           dtype=torch.int32,
                                           device=sh.device)

                text = torch.as_tensor(
                    np.concatenate([r["text"] for r in recs]),
                    device=sh.device)
                q0 = torch.as_tensor(np.concatenate(
                    [r["prompts"][..., 0] for r in recs]), device=sh.device)
                text_lens, p_lens = col("text_len"), col("p_len")
                kb, vb, lg0 = cb_prefill(
                    sh.model, text, text_lens, q0, p_lens,
                    cache_len=self.cache_len,
                    compute_dtype=self.compute_dtype)
                cb_install_many(tables[i], [s for s, _ in mine], kb, vb, lg0,
                                text_lens, p_lens + bos)

            self._map(install)
            self._sync()
            stats["install_s"] += time.perf_counter() - t0

        def decode(i, sh, K):
            """Sub-table i's chunk: its steps and its draws (none when
            no lane of it is live)."""
            if all(o is None for o in occupant[i * lanes:(i + 1) * lanes]):
                return 0
            gen = (sh.generator if self._shards is None else RowDraws(
                sh.generator, self.slots,
                range(i * lanes, (i + 1) * lanes)))
            return cb_decode_chunk(
                sh.model, tables[i], self.temperature, S=self.text_pad, K=K,
                top_k=self.top_k, generator=gen,
                compute_dtype=self.compute_dtype)

        refill(list(range(self.slots)))
        while any(o is not None for o in occupant):
            # no more steps than the longest live lane can still take
            left = max(self._last_step(occupant[s][1]) + 1 - steps[s]
                       for s in range(self.slots) if occupant[s] is not None)
            K = max(1, min(self.chunk, left))
            t0 = time.perf_counter()
            runs = self._map(lambda i, sh: decode(i, sh, K))
            if self._shards is not None:
                _sync_generators(self._shards.shards, runs)
            n = max(runs)
            # the chunks have synchronized
            done = np.concatenate([tb["done"].cpu().numpy()
                                   for tb in tables])
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
            read = {}                        # sub-table -> its codes, lens
            for slot in freed:
                idx, rec = occupant[slot]
                i, j = divmod(slot, lanes)
                if i not in read:
                    read[i] = (tables[i]["gen_codes"].cpu().numpy(),
                               tables[i]["gen_lens"].cpu().numpy())
                finished[idx] = (read[i][0][j].copy(), int(read[i][1][j]),
                                 rec)
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
        each group's rows split over the shards, then the codec on
        ``device``."""
        from .models.inference import valle_nar_finish

        lanes = self._lanes
        order = sorted(finished)
        results = []
        for lo in range(0, len(order), self.slots):
            idxs = order[lo: lo + self.slots]
            rows = idxs + [idxs[0]] * (self.slots - len(idxs))

            def nar(i, sh):
                mine = rows[i * lanes:(i + 1) * lanes]
                recs = [finished[r][2] for r in mine]
                dev = sh.device

                def stack(key):
                    return torch.as_tensor(np.asarray(
                        [r[key] for r in recs], np.int32), device=dev)

                return valle_nar_finish(
                    sh.model,
                    torch.as_tensor(np.concatenate([r["text"] for r in recs]),
                                    device=dev),
                    stack("text_len"),
                    torch.as_tensor(np.concatenate(
                        [r["prompts"] for r in recs]), device=dev),
                    stack("p_len"),
                    torch.as_tensor(np.stack([finished[r][0] for r in mine]),
                                    device=dev),
                    torch.as_tensor(np.asarray(
                        [finished[r][1] for r in mine], np.int32),
                        device=dev),
                    stack("enroll_len"),
                    compute_dtype=self.compute_dtype,
                    nar_score_bf16=self.nar_score_bf16,
                    nar_attn_impl=self.nar_attn_impl)

            codes = torch.cat([c.to(self.device) for c in self._map(nar)])
            gen_lens = np.asarray([finished[r][1] for r in rows], np.int32)
            results += _results(self.audio_tokenizer, codes, gen_lens,
                                len(idxs), self.codec_dtype,
                                self.wav_transfer)
        return results
