"""Continuous-batching AR decode: a KV-cache slot table whose finished lanes
are refilled with queued requests (mirror of
``valle_tpu/models/cb_decode.py``).

- :func:`cb_state_init` -- an empty slot table on a device;
- :func:`cb_prefill` -- b requests' prefix forward: their KV rows and
  first-token logits;
- :func:`cb_install` / :func:`cb_install_many` -- write prefilled requests
  into slots, in place; a refill wave is one prefill at a fixed width plus
  one ``cb_install_many``;
- :func:`cb_decode_chunk` -- advance every slot up to K tokens.

The per-step math of a live lane is ``valle_ar_decode``'s, through the
same helpers of ``models/inference.py`` (the stop rule, the embedding with
``alpha * pe``, the step mask; one categorical draw a step for all
slots); the CB adds its per-lane budget and frozen lanes. So a batch
admitted at once reproduces the batch decode, sampled tokens included,
from the same generator state, and a recycled slot reproduces the
single-request decode (greedy). Prenets (the audio prenet in the step's
input, the text prenet in the prefill) and post-norm stacks come through
those shared pieces, as JAX's come through its (``valle_tpu/models/
cb_decode.py:232-248``). Finished lanes are frozen: their logits
and progress ``g`` hold, and their generated codes are not written
again.

A chunk reads the device every ``DONE_CHECK_EVERY`` steps and after its
last step, one small read of whether every slot is done and whether a
draw saw probabilities that are not finite: it stops once every slot is
done, as JAX's loop does, and raises where ``torch.multinomial`` would
have (``ops/sampling.check_draws``). Between two reads it runs on: a
frozen lane rewrites the same cache row with the same value, so the
steps after the last lane's stop change no result, only how far the
generator has advanced (deterministically). The caller also bounds K by
the lanes' 16x caps and budgets (``serving.ContinuousBatcher``). JAX's
CB step adds the bare PE row (``valle_tpu/models/cb_decode.py:236``);
the port applies ``alpha`` as its prefill and ``valle_ar_decode`` do
(ROADMAP C4). The decode step is the plain ``exact`` path: the kernel
decode modes are left out, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..modules.transformer import (encoder_stack_decode_step,
                                   encoder_stack_prefill)
from ..ops import masks as M
from ..ops.sampling import check_draws
from .inference import (_frontends, ar_step_input, ar_stop_step,
                        decode_step_bias)
from .valle import VALLE, pe_table

# decode steps between two reads of the device inside a chunk
DONE_CHECK_EVERY = 8


def cb_state_init(cfg, *, slots: int, cache_len: int, max_gen_len: int,
                  device="cuda", compute_dtype=torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """An empty slot table on ``device``: every slot done. k/v (L, slots,
    H, cache_len, Dh) in the compute dtype, logits (slots, V+1) fp32, and
    int32 per-slot ``x_lens``, ``p_lens`` (BOS included), ``g``,
    ``gen_codes`` (slots, max_gen_len) and ``gen_lens``. The random draws
    come from a generator the caller holds."""
    L, H = cfg.num_layers, cfg.nhead
    dh = cfg.d_model // H
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "k": torch.zeros(L, slots, H, cache_len, dh, dtype=compute_dtype,
                         device=device),
        "v": torch.zeros(L, slots, H, cache_len, dh, dtype=compute_dtype,
                         device=device),
        "logits": torch.zeros(slots, cfg.num_audio_tokens + 1,
                              dtype=torch.float32, device=device),
        "x_lens": torch.zeros(slots, **i32),
        "p_lens": torch.zeros(slots, **i32),
        "g": torch.zeros(slots, **i32),
        "done": torch.ones(slots, dtype=torch.bool, device=device),
        "gen_codes": torch.zeros(slots, max_gen_len, **i32),
        "gen_lens": torch.full((slots,), max_gen_len, **i32),
    }


@torch.no_grad()
def cb_prefill(model: VALLE, text, text_lens, prompt_q0, prompt_lens, *,
               cache_len: int, compute_dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix forward of b requests (text (b, S) padded, quantizer-0
    prompt codes (b, P)). Returns (k, v (L, b, H, cache_len, Dh), logits0
    (b, V+1) fp32): their KV rows, zero past the prefix, and the logits of
    the last prompt position. Under the flash switch its attention is B6
    (``ops/attention.py``)."""
    cfg = model.cfg
    dev = text.device
    b, S = text.shape
    bos = int(cfg.prepend_bos)
    dtype = compute_dtype
    x_lens = text_lens.to(dev, torch.int64)
    p_lens = prompt_lens.to(dev, torch.int64) + bos
    P = prompt_q0.shape[1]
    x, y = _frontends(model, text, prompt_q0, dtype)
    bias = M.ar_xy_attn_bias(x_lens, p_lens, S, bos + P)
    hidden, cache = encoder_stack_prefill(
        model.ar_decoder, torch.cat([x, y], dim=1), bias,
        cache_len=cache_len, activation=cfg.activation, dtype=dtype)
    W = model.ar_predict_layer.weight.to(dtype)
    last = hidden[torch.arange(b, device=dev), S + p_lens - 1]
    return cache["k"], cache["v"], (last @ W.T).float()


@torch.no_grad()
def cb_install(st, slot: int, k1, v1, logits0, x_len, p_len_with_bos):
    """Install one prefilled request (k1, v1 (L, 1, H, T, Dh)) into
    ``slot``, in place: the slot's whole cache row is overwritten, so a
    recycled slot never reads its previous occupant's keys. Returns st."""
    st["k"][:, slot] = k1[:, 0].to(st["k"].dtype)
    st["v"][:, slot] = v1[:, 0].to(st["v"].dtype)
    st["logits"][slot] = logits0.reshape(-1).float()
    st["x_lens"][slot] = int(x_len)
    st["p_lens"][slot] = int(p_len_with_bos)
    st["g"][slot] = 0
    st["done"][slot] = False
    st["gen_codes"][slot] = 0
    st["gen_lens"][slot] = st["gen_codes"].shape[1]
    return st


@torch.no_grad()
def cb_install_many(st, slots, kb, vb, logits0, x_lens, p_lens_with_bos):
    """Install b prefilled requests into ``slots`` (b,) in one indexed
    write per tensor, in place. Returns st.

    Padding contract (JAX's): the caller pads ``slots`` and every operand
    row to the fixed width b by repeating row 0, slot index and values.
    ``index_put_`` leaves the order of duplicate indices unspecified, but
    duplicates that carry equal values give one result whichever write
    lands last, and re-installing a freshly prefilled request is
    idempotent."""
    dev = st["k"].device
    idx = torch.as_tensor(slots, device=dev).long()
    b = idx.shape[0]
    st["k"][:, idx] = kb.to(dev, st["k"].dtype)
    st["v"][:, idx] = vb.to(dev, st["v"].dtype)
    st["logits"][idx] = logits0.to(dev, torch.float32)
    st["x_lens"][idx] = torch.as_tensor(x_lens, device=dev).to(torch.int32)
    st["p_lens"][idx] = torch.as_tensor(p_lens_with_bos,
                                        device=dev).to(torch.int32)
    st["g"][idx] = torch.zeros(b, dtype=torch.int32, device=dev)
    st["done"][idx] = torch.zeros(b, dtype=torch.bool, device=dev)
    Gmax = st["gen_codes"].shape[1]
    st["gen_codes"][idx] = torch.zeros(b, Gmax, dtype=torch.int32,
                                       device=dev)
    st["gen_lens"][idx] = torch.full((b,), Gmax, dtype=torch.int32,
                                     device=dev)
    return st


@torch.no_grad()
def cb_decode_chunk(model: VALLE, st, temperature: float = 1.0, *, S: int,
                    K: int, top_k: int = -100,
                    generator: Optional[torch.Generator] = None,
                    compute_dtype=torch.float32) -> int:
    """Advance every slot up to K steps, in place; ``S`` is the padded
    text width of every request. A live lane stops on the reference rule
    (``ar_stop_step``) or at its budget ``g >= max_gen_len``; ``gen_lens``
    takes its g there. Returns the steps run: fewer than K when every slot
    is done at a read (every ``DONE_CHECK_EVERY`` steps)."""
    cfg = model.cfg
    dtype = compute_dtype
    dev = st["k"].device
    ck, cv = st["k"], st["v"]
    B, Tc = ck.shape[1], ck.shape[3]
    Gmax = st["gen_codes"].shape[1]
    W = model.ar_predict_layer.weight.to(dtype)
    pe = pe_table(cfg, cfg.d_model, device=dev)
    bidx = torch.arange(B, device=dev)
    kk = torch.arange(Tc, device=dev)[None, :]
    x_lens = st["x_lens"].long()                 # chunk-invariant
    p_lens = st["p_lens"].long()
    logits, g, done = st["logits"], st["g"].long(), st["done"]
    gen_codes, gen_lens = st["gen_codes"], st["gen_lens"]
    invalid = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = 0
    while steps < K:
        # g >= Gmax is the batch decode's loop bound, per lane
        tok, done, gen_lens = ar_stop_step(
            logits, g, done, gen_lens, x_lens, cfg, generator=generator,
            top_k=top_k, temperature=temperature, invalid=invalid,
            extra_stop=g >= Gmax)
        gw = g.clamp(max=Gmax - 1)
        gen_codes[bidx, gw] = torch.where(done, gen_codes[bidx, gw],
                                          tok.to(torch.int32))
        audio_pos = p_lens + g
        write_pos = S + audio_pos
        hidden = encoder_stack_decode_step(
            model.ar_decoder, ar_step_input(model, tok, audio_pos, pe, dtype),
            {"k": ck, "v": cv}, write_pos,
            decode_step_bias(x_lens, write_pos, S, kk),
            activation=cfg.activation, dtype=dtype, mode="exact")
        new_logits = (hidden[:, 0] @ W.T).float()
        # frozen lanes hold their logits and progress until a refill
        logits = torch.where(done[:, None], logits, new_logits)
        g = torch.where(done, g, g + 1)
        steps += 1
        if steps % DONE_CHECK_EVERY == 0 or steps == K:
            all_done, bad = torch.stack([done.all(),
                                         invalid.any()]).tolist()
            if bad:
                check_draws(invalid, "cb_decode_chunk")
            if all_done:
                break
    st["logits"], st["g"], st["done"] = logits, g.to(torch.int32), done
    st["gen_lens"] = gen_lens
    return steps
