"""The AR step of ``valle_ar_decode`` as one function (``models/inference.py``):
on the CPU the loop runs it eagerly every step, giving the codes, lengths,
spans and counters of the loop it replaced (kept below as the reference),
in a plain mode, a fused mode and the int8 cache's, with one write
position for all rows or one a row; the choice between the eager loop and
the CUDA graph replay (``use_step_graph``) takes the eager loop on the CPU
and for a stack cut into model shards. The graph itself runs on a card
only (``tests/test_torch_port_cuda.py``)."""

import pytest
import torch

from valle_tpu_torch.models import inference as inf
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.modules.transformer import (CACHE_KINDS,
                                                 encoder_stack_decode_step,
                                                 encoder_stack_prefill)
from valle_tpu_torch.ops import masks as M
from valle_tpu_torch.ops.sampling import check_draws
from valle_tpu_torch.parallel.tensor import ModelShard
from valle_tpu_torch.utils import tracing

from torch_port_helpers import one_thread  # noqa: F401  (autouse)

B, S, P = 8, 12, 10


@torch.no_grad()
def reference_ar_decode(model, text, text_lens, prompt_q0, prompt_lens, *,
                        generator, top_k, max_gen_len, aligned_prompts,
                        decode_mode):
    """The step loop as it was before its body became one function: the
    positions from the host's step number, the body inline."""
    cfg = model.cfg
    dev = text.device
    Bt, St = text.shape
    decode_mode = inf.resolve_decode_mode(decode_mode, cfg, B=Bt, S=St,
                                          P=prompt_q0.shape[1],
                                          max_gen_len=max_gen_len)
    bos = int(cfg.prepend_bos)
    dtype = torch.float32
    x_lens = text_lens.to(dev, torch.int64)
    p_lens = prompt_lens.to(dev, torch.int64) + bos
    cache_len = inf.cache_rows(St + bos + prompt_q0.shape[1] + max_gen_len
                               + 1, decode_mode, cfg.nhead)
    kernel_attn = decode_mode in CACHE_KINDS
    with tracing.span("ar.prefill", device=dev):
        x, y = inf._frontends(model, text, prompt_q0, dtype)
        bias = M.ar_xy_attn_bias(x_lens, p_lens, St,
                                 bos + prompt_q0.shape[1])
        dec = model.ar_decoder
        hidden, cache = encoder_stack_prefill(
            dec, torch.cat([x, y], dim=1), bias, cache_len=cache_len,
            activation=cfg.activation, dtype=dtype)
        cache = inf.convert_cache(cache, decode_mode)
        x_lens32 = x_lens.to(torch.int32)
        W = model.ar_predict_layer.weight.to(dtype)
        logits = (hidden[torch.arange(Bt), St + p_lens - 1] @ W.T).float()
    pe = inf.pe_table(cfg, cfg.d_model, device=dev)
    kk = torch.arange(cache_len, device=dev)[None, :]
    done = torch.zeros(Bt, dtype=torch.bool)
    invalid = torch.zeros(Bt, dtype=torch.bool)
    gen_codes = torch.zeros(Bt, max_gen_len, dtype=torch.int32)
    gen_lens = torch.full((Bt,), max_gen_len, dtype=torch.int32)
    steps = max_gen_len
    for g in range(max_gen_len):
        with tracing.span("ar.step") as step:
            if inf._stopped(done, False):
                step.drop()
                steps = g
                break
            with tracing.span("ar.sample"):
                tok, done, gen_lens = inf.ar_stop_step(
                    logits, g, done, gen_lens, x_lens, cfg,
                    generator=generator, top_k=top_k, temperature=1.0,
                    invalid=invalid)
                gen_codes[:, g] = torch.where(done, 0, tok).to(torch.int32)
            with tracing.span("ar.embed"):
                if aligned_prompts:
                    audio_pos = p_lens[:1] + g
                    write_pos = (St + audio_pos)[0]
                else:
                    audio_pos = p_lens + g
                    write_pos = St + audio_pos
                xstep = inf.ar_step_input(model, tok, audio_pos, pe, dtype)
            with tracing.span("ar.stack"):
                wp = write_pos.expand(Bt) if aligned_prompts else write_pos
                if kernel_attn:
                    step_bias = None
                    kctx = (x_lens32, wp.to(torch.int32).contiguous(), St)
                else:
                    step_bias = inf.decode_step_bias(x_lens, wp, St, kk)
                    kctx = None
                hidden_s = encoder_stack_decode_step(
                    dec, xstep, cache, write_pos, step_bias,
                    activation=cfg.activation, dtype=dtype,
                    mode=decode_mode, kernel_ctx=kctx)
            with tracing.span("ar.head"):
                logits = (hidden_s[:, 0] @ W.T).float()
    tracing.count("ar.row_steps", Bt * steps)
    check_draws(invalid, "valle_ar_decode")
    return gen_codes, gen_lens


@pytest.fixture(scope="module")
def model():
    """A seeded VALL-E at d 128 (the fused modes' smallest width), Dh 64."""
    torch.manual_seed(0)
    m = VALLE(ValleConfig(d_model=128, nhead=2, num_layers=2, prefix_mode=1,
                          max_len=512))
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.ndim > 1:
                p.normal_(0.0, p.shape[-1] ** -0.5)
            elif name.endswith(("weight", "alpha")):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.1)
    return m.eval()


def _inputs(aligned: bool):
    gen = torch.Generator().manual_seed(3)
    text = torch.randint(3, 30, (B, S), generator=gen)
    text_lens = torch.tensor([12, 3, 7, 12, 5, 9, 2, 11])
    prompt = torch.randint(0, 1024, (B, P), generator=gen)
    prompt_lens = (torch.full((B,), P) if aligned
                   else torch.tensor([10, 4, 10, 7, 10, 2, 9, 6]))
    return text, text_lens, prompt, prompt_lens


def _traced(fn, *args, **kw):
    """fn's result, with its spans as (name, parent's name) in the order
    they ended, and its counters."""
    tracing.enable()
    try:
        out = fn(*args, **kw)
    finally:
        tracing.disable()
    spans = tracing.spans()
    names = {s["id"]: s["name"] for s in spans}
    return out, [(s["name"], names.get(s["parent"])) for s in spans], \
        tracing.counters()


@pytest.mark.parametrize("mode,aligned", [("int8", False), ("exact", False),
                                          ("fused", False), ("int8", True),
                                          ("exact", True)])
def test_step_function_gives_the_loop_it_replaced(model, mode, aligned,
                                                  monkeypatch):
    """Sampled codes (top-k 5, one seed), lengths, the spans of every step
    and the counters equal the reference loop's; the CPU never builds a
    graph and counts no replayed step. Rows stop on the 16 x text rule at
    different steps, and the loop ends before its budget."""
    def no_graph(*a, **k):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(inf, "StepGraph", no_graph)
    args = (model,) + _inputs(aligned)
    kw = dict(top_k=5, max_gen_len=260, aligned_prompts=aligned,
              decode_mode=mode)
    (codes, lens), spans, counters = _traced(
        inf.valle_ar_decode, *args,
        generator=torch.Generator().manual_seed(7), **kw)
    (ref_codes, ref_lens), ref_spans, ref_counters = _traced(
        reference_ar_decode, *args,
        generator=torch.Generator().manual_seed(7), **kw)
    assert torch.equal(codes, ref_codes) and torch.equal(lens, ref_lens)
    assert len(set(lens.tolist())) > 2 and int(lens.max()) < 260
    assert spans == ref_spans
    assert ("ar.stack", "ar.step") in spans
    assert counters == dict(ref_counters, **{"ar.graph_steps": 0})


def test_graph_is_taken_on_a_card_over_a_whole_stack(model):
    """The decision reads the device and the stack alone: the CPU and a
    stack that holds a model shard take the eager loop, a whole stack on
    a card the graph."""
    stack = model.ar_decoder
    assert not inf.use_step_graph(stack, torch.device("cpu"))
    assert inf.use_step_graph(stack, torch.device("cuda", 0))
    attn = stack.layers[0].self_attn
    attn.model_shard = ModelShard(tp=2, index=0)
    try:
        assert not inf.use_step_graph(stack, torch.device("cuda", 0))
        assert not inf.use_step_graph(stack, torch.device("cpu"))
    finally:
        del attn.model_shard
