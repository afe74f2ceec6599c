"""Continuous batching in the port (``models/cb_decode.py``,
``serving.ContinuousBatcher``) against the JAX package's, on the CPU at
fp32: the slot table after prefill, install and decode chunks, recycled
slots, sampled draws against the port's batch decode, the scheduler end
to end, and the alpha rule of the decode step (ROADMAP C4).

A tiny model as ``tests/test_continuous_batching.py`` uses (d 32, 2 heads,
2 layers), alpha 1 except in the C4 case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.data import TextTokenizer as JaxTextTokenizer
from valle_tpu.data.collation import TextTokenCollater as JaxCollater
from valle_tpu.models import ValleModel
from valle_tpu.models import cb_decode as jcb
from valle_tpu.serving import ContinuousBatcher as JaxBatcher
from valle_tpu.serving import SynthesisRequest as JaxRequest
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models import cb_decode as pcb
from valle_tpu_torch.models.inference import valle_ar_decode
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.ops.sampling import categorical
from valle_tpu_torch.parallel.mesh import Mesh, make_mesh
from valle_tpu_torch.serving import (ContinuousBatcher, RequestError,
                                     SynthesisRequest, Synthesizer)
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict)

from torch_port_helpers import make_pair, t
from torch_port_helpers import jax_audio_tokenizer
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

TINY = dict(d_model=32, nhead=2, num_layers=2, max_prefix_len=8)
SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
S, P = 12, 8


def _inputs(seed, b):
    rng = np.random.RandomState(seed)
    return {"text": rng.randint(3, 100, (b, S)).astype(np.int32),
            "text_lens": np.array([S, S - 4, 1, 3][:b], np.int32),
            "prompts": rng.randint(0, 1024, (b, P)).astype(np.int32),
            "p_lens": np.array([P, P - 3, P - 1, 2][:b], np.int32)}


def _close(name, got, ref, rel=1e-6):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.numpy() - ref).max()
    assert err <= rel * np.abs(ref).max(), (name, err)


def _same_table(st, jst, what):
    for key in ("k", "v", "logits"):
        _close(f"{what}: {key}", st[key], jst[key])
    for key in ("x_lens", "p_lens", "g", "done", "gen_codes", "gen_lens"):
        assert np.array_equal(st[key].numpy(), np.asarray(jst[key])), (
            what, key)


def test_cb_pieces_match_jax():
    """fp32 greedy: the port's prefill, padded install and decode chunks
    give JAX's slot table (k/v/logits to 1e-6 of the largest entry, the
    integer state bit for bit): a wave of 2 into non-contiguous slots
    [3, 1] of 4, padded by repeating row 0, a live bystander slot kept;
    then chunks of 5 steps until every slot is done."""
    jcfg, params, model = make_pair(**TINY)
    bos = int(jcfg.prepend_bos)
    slots, G = 4, 16
    cache_len = S + bos + P + G + 1
    x = _inputs(3, 2)
    jk, jv, jlg = jcb.cb_prefill(
        params, jcfg, *(jnp.asarray(x[n]) for n in
                        ("text", "text_lens", "prompts", "p_lens")),
        cache_len=cache_len)
    k, v, lg = pcb.cb_prefill(model, t(x["text"]), t(x["text_lens"]),
                              t(x["prompts"]), t(x["p_lens"]),
                              cache_len=cache_len)
    for name, a, b in (("k", k, jk), ("v", v, jv), ("logits0", lg, jlg)):
        _close(name, a, b)

    target, pad = [3, 1], slots - 2
    rep = lambda a, axis: np.concatenate(                      # noqa: E731
        [a, np.repeat(np.take(a, [0], axis=axis), pad, axis=axis)], axis)
    wave = (np.asarray(target + [target[0]] * pad, np.int32),
            rep(np.asarray(jk), 1), rep(np.asarray(jv), 1),
            rep(np.asarray(jlg), 0), rep(x["text_lens"], 0),
            rep(x["p_lens"] + bos, 0))
    for bystander in (True, False):
        jst = jcb.cb_state_init(jcfg, slots=slots, cache_len=cache_len,
                                max_gen_len=G, rng=jax.random.PRNGKey(0))
        st = pcb.cb_state_init(jcfg, slots=slots, cache_len=cache_len,
                               max_gen_len=G, device="cpu")
        if bystander:   # a live slot the scatter must not touch
            jst["done"] = jst["done"].at[0].set(False)
            jst["g"] = jst["g"].at[0].set(7)
            st["done"][0], st["g"][0] = False, 7
        jst = jcb.cb_install_many(jst, *(jnp.asarray(a) for a in wave))
        pcb.cb_install_many(st, *(t(a) for a in wave))
        _same_table(st, jst, "install")
        if bystander:
            assert not bool(st["done"][0]) and int(st["g"][0]) == 7
    # slots 0 and 2 stay empty (done) while 3 and 1 decode
    for chunk in range(5):
        jst = jcb.cb_decode_chunk(params, jst, 1.0, cfg=jcfg, S=S, K=5,
                                  top_k=1)
        pcb.cb_decode_chunk(model, st, 1.0, S=S, K=5, top_k=1)
        _same_table(st, jst, f"chunk {chunk}")
        if bool(st["done"].all()):
            break
    assert bool(st["done"].all()) and chunk > 0
    assert all(0 < int(st["gen_lens"][s]) <= G for s in target)


def test_cb_chunk_stops_once_every_slot_is_done():
    """A chunk of K 64 over two lanes that stop at step 17 - bos (16x cap)
    and 40 (budget) ends at the first read after the last stop (step 48, a
    read every DONE_CHECK_EVERY steps) with JAX's slot table, whose loop
    stops when every slot is done; a live slot whose logits hold a NaN
    makes the chunk raise at its read, as torch.multinomial would."""
    jcfg, params, model = make_pair(**TINY)
    bos = int(jcfg.prepend_bos)
    G = 40
    cache_len = S + bos + P + G + 1
    x = {k: v[2:] for k, v in _inputs(3, 4).items()}     # text lens 1, 3
    x["text_lens"] = np.array([1, 3], np.int32)
    args = [x[n] for n in ("text", "text_lens", "prompts", "p_lens")]
    jst = jcb.cb_state_init(jcfg, slots=2, cache_len=cache_len,
                            max_gen_len=G, rng=jax.random.PRNGKey(0))
    jk, jv, jlg = jcb.cb_prefill(params, jcfg, *map(jnp.asarray, args),
                                 cache_len=cache_len)
    jst = jcb.cb_install_many(jst, jnp.arange(2), jk, jv, jlg,
                              jnp.asarray(x["text_lens"]),
                              jnp.asarray(x["p_lens"] + bos))
    jst = jcb.cb_decode_chunk(params, jst, 1.0, cfg=jcfg, S=S, K=64,
                              top_k=1)
    st = pcb.cb_state_init(jcfg, slots=2, cache_len=cache_len,
                           max_gen_len=G, device="cpu")
    k, v, lg = pcb.cb_prefill(model, *map(t, args), cache_len=cache_len)
    pcb.cb_install_many(st, torch.arange(2), k, v, lg, t(x["text_lens"]),
                        t(x["p_lens"] + bos))
    assert pcb.cb_decode_chunk(model, st, 1.0, S=S, K=64, top_k=1) == 48
    _same_table(st, jst, "one chunk")
    assert st["gen_lens"].tolist() == [17 - bos, 40]

    pcb.cb_install_many(st, torch.arange(2), k, v, lg, t(x["text_lens"]),
                        t(x["p_lens"] + bos))
    st["logits"][1, 5] = float("nan")
    with pytest.raises(RuntimeError,
                       match=r"cb_decode_chunk.*\[1\].*not finite"):
        pcb.cb_decode_chunk(model, st, 1.0, S=S, K=64, top_k=1)


def test_cb_recycled_slots_match_jax_and_single_decode():
    """5 requests through 2 slots, greedy, installed one by one as slots
    free (``tests/test_continuous_batching.py:82``): each request's codes
    and length equal the JAX CB run's and the port's single-request
    ``valle_ar_decode``'s; a recycled slot never reads its previous
    occupant's keys."""
    jcfg, params, model = make_pair(**TINY)
    bos = int(jcfg.prepend_bos)
    N, slots, G = 5, 2, 24
    cache_len = S + bos + P + G + 1
    rng = np.random.RandomState(7)
    texts = [rng.randint(3, 100, (1, S)).astype(np.int32) for _ in range(N)]
    tlens = [np.array([1 + (i % 3)], np.int32) for i in range(N)]
    proms = [rng.randint(0, 1024, (1, P)).astype(np.int32) for _ in range(N)]
    plens = [np.array([P - (i % 4)], np.int32) for i in range(N)]

    def serve(jax_side):
        if jax_side:
            st = jcb.cb_state_init(jcfg, slots=slots, cache_len=cache_len,
                                   max_gen_len=G, rng=jax.random.PRNGKey(1))
        else:
            st = pcb.cb_state_init(jcfg, slots=slots, cache_len=cache_len,
                                   max_gen_len=G, device="cpu")
        queue, occupant, out = list(range(N))[::-1], [None] * slots, {}

        def install(st, slot, i):
            occupant[slot] = i
            a = (texts[i], tlens[i], proms[i], plens[i])
            if jax_side:
                k1, v1, lg0 = jcb.cb_prefill(
                    params, jcfg, *map(jnp.asarray, a), cache_len=cache_len)
                return jcb.cb_install(st, jnp.int32(slot), k1, v1, lg0,
                                      tlens[i][0], plens[i][0] + bos)
            k1, v1, lg0 = pcb.cb_prefill(model, *map(t, a),
                                         cache_len=cache_len)
            return pcb.cb_install(st, slot, k1, v1, lg0, tlens[i][0],
                                  plens[i][0] + bos)

        for s in range(slots):
            st = install(st, s, queue.pop())
        while any(o is not None for o in occupant):
            if jax_side:
                st = jcb.cb_decode_chunk(params, st, 1.0, cfg=jcfg, S=S, K=4,
                                         top_k=1)
            else:
                pcb.cb_decode_chunk(model, st, 1.0, S=S, K=4, top_k=1)
            done = np.asarray(st["done"])
            codes, lens = np.asarray(st["gen_codes"]), np.asarray(
                st["gen_lens"])
            for s in range(slots):
                if occupant[s] is None or not done[s]:
                    continue
                out[occupant[s]] = (codes[s].copy(), int(lens[s]))
                occupant[s] = None
                if queue:
                    st = install(st, s, queue.pop())
        return out

    got, ref = serve(False), serve(True)
    assert sorted(got) == list(range(N))
    for i in range(N):
        assert got[i][1] == ref[i][1]
        assert np.array_equal(got[i][0], ref[i][0])
        one = valle_ar_decode(model, t(texts[i]), t(tlens[i]), t(proms[i]),
                              t(plens[i]), top_k=1, max_gen_len=G)
        assert int(one[1][0]) == got[i][1]
        assert np.array_equal(one[0][0].numpy(), got[i][0])


def test_cb_sampled_draws_match_port_batch_decode():
    """top_k 10: a batch admitted at once in one wave decodes the tokens
    of the port's ``valle_ar_decode`` from the same generator seed (one
    categorical draw a step for all slots), over chunks of 5."""
    _, _, model = make_pair(**TINY)
    cfg, B, G = model.cfg, 4, 24
    x = _inputs(1, B)
    args = [t(x[n]) for n in ("text", "text_lens", "prompts", "p_lens")]
    ref = valle_ar_decode(model, *args, top_k=10, max_gen_len=G,
                          generator=torch.Generator().manual_seed(5))
    cache_len = S + int(cfg.prepend_bos) + P + G + 1
    st = pcb.cb_state_init(cfg, slots=B, cache_len=cache_len, max_gen_len=G,
                           device="cpu")
    k, v, lg = pcb.cb_prefill(model, *args, cache_len=cache_len)
    pcb.cb_install_many(st, torch.arange(B), k, v, lg, args[1],
                        args[3] + int(cfg.prepend_bos))
    gen = torch.Generator().manual_seed(5)
    while not bool(st["done"].all()):
        pcb.cb_decode_chunk(model, st, 1.0, S=S, K=5, top_k=10,
                            generator=gen)
    assert torch.equal(st["gen_lens"], ref[1])
    assert torch.equal(st["gen_codes"], ref[0])
    assert len(set(st["gen_codes"][0].tolist())) > 1


def test_categorical_draws_multinomial_indices():
    """The sync-free draw gives torch.multinomial's indices and leaves the
    generator where multinomial leaves it."""
    lg = torch.randn(6, 1025, generator=torch.Generator().manual_seed(0)) * 3
    lg[1, 7:] = float("-inf")
    probs = torch.softmax(lg, dim=-1)
    for seed in range(5):
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        assert torch.equal(categorical(lg, g2), want)
        assert torch.equal(g1.get_state(), g2.get_state())


def test_nan_logits_raise_in_the_batch_decode():
    """valle_ar_decode raises, as torch.multinomial does, when a draw
    sees NaN probabilities, and ``categorical`` marks exactly the rows
    multinomial refuses: a NaN, a +inf, no finite logit."""
    lg = torch.zeros(5, 9)
    lg[0, 3], lg[1, 2], lg[2] = float("nan"), float("inf"), float("-inf")
    lg[3, 4:] = float("-inf")
    invalid = torch.zeros(5, dtype=torch.bool)
    categorical(lg, torch.Generator().manual_seed(0), invalid)
    assert invalid.tolist() == [True, True, True, False, False]
    for row in range(3):
        with pytest.raises(RuntimeError):
            torch.multinomial(torch.softmax(lg[row: row + 1], -1), 1)
    _, _, model = make_pair(**TINY)
    x = _inputs(1, 2)
    with torch.no_grad():
        model.ar_predict_layer.weight[7, 0] = float("nan")
    with pytest.raises(RuntimeError, match="valle_ar_decode.*not finite"):
        valle_ar_decode(model, *(t(x[n]) for n in ("text", "text_lens",
                                                    "prompts", "p_lens")),
                        top_k=1, max_gen_len=4)


def _batchers(admission, **kw):
    """(JAX ContinuousBatcher, port ContinuousBatcher, port Synthesizer)
    on one tiny model and codec, fp32 compute and codec, float32 wav
    transfer."""
    jcfg, params, model = make_pair(**TINY, prefix_mode=1)
    jtok = jax_audio_tokenizer()
    tok = AudioTokenizer(device="cpu")
    load_numpy_state_dict(tok.codec, encodec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtok.params)))
    common = dict(slots=2, text_pad=32, prompt_pad=8, max_gen_len=16,
                  chunk=4, top_k=1, codec_dtype="float32",
                  wav_transfer="float32", admission=admission)
    common.update(kw)
    jcb_ = JaxBatcher(ValleModel(jcfg), params,
                      JaxTextTokenizer(backend="char"), JaxCollater(SYMBOLS),
                      jtok, compute_dtype=jnp.float32, **common)
    cb = ContinuousBatcher(model, TextTokenizer(backend="char"),
                           TextTokenCollater(SYMBOLS), tok,
                           compute_dtype=torch.float32, device="cpu",
                           **common)
    synth = Synthesizer(model, TextTokenizer(backend="char"),
                        TextTokenCollater(SYMBOLS), tok, top_k=1,
                        max_gen_len=16, compute_dtype=torch.float32,
                        codec_dtype="float32", wav_transfer="float32",
                        device="cpu")
    return jcb_, cb, synth


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(text=s, prompt_codes=rng.randint(0, 1024, (5, 8)))
            for s in ("hello there", "one more", "third request text",
                      "tiny", "fifth and final sentence")]


@pytest.mark.parametrize("admission", ["lpt", "fifo"])
def test_continuous_batcher_matches_jax_and_synthesizer(admission):
    """5 requests through 2 slots, prefix mode 1, greedy: the port's
    ContinuousBatcher gives the JAX ContinuousBatcher's codes and frames
    (wav within 1e-5) and the port Synthesizer's, in submission order
    under either admission order."""
    jcb_, cb, synth = _batchers(admission)
    ref = jcb_.run(_requests(JaxRequest))
    got = cb.run(_requests(SynthesisRequest))
    syn = synth.synthesize(_requests(SynthesisRequest), max_gen_len=16)
    assert len(got) == len(ref) == len(syn) == 5
    for a, b, c in zip(got, ref, syn):
        assert a.frames == b.frames == c.frames
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.codes, c.codes)
        assert a.wav.shape == (a.frames * 320,)
        np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=1e-5)
    s = cb.last_stats
    assert s["waves"] >= 3 and s["chunks"] >= 2
    assert s["steps"] >= s["chunks"] and s["decode_s"] > 0


def test_continuous_batcher_eos_endings_match_synthesizer():
    """Lanes that end by EOS mid-chunk: the AR head's EOS row is made 1.01
    x the row of a token that three greedy decodes emit early, so each
    lane stops where it would first emit that token. One slot, chunks of
    16: the batcher still gives the Synthesizer's codes and frames, and
    runs fewer steps than it planned (a chunk stops at the read after its
    lane's stop)."""
    _, cb, synth = _batchers("fifo", slots=1, chunk=16)
    ref = synth.synthesize(_requests(SynthesisRequest), max_gen_len=16)
    first = [{} for _ in ref]           # token -> frame of its first use
    for r, d in zip(ref, first):
        for f, tok in enumerate(r.codes[:, 0].tolist()):
            d.setdefault(tok, f)
    tok = max({k for d in first for k in d}, key=lambda k: (
        sum(k in d for d in first), -sum(d.get(k, 0) for d in first), -k))
    with torch.no_grad():
        w = cb.model.ar_predict_layer.weight
        w[cb.model.cfg.eos_id] = 1.01 * w[tok]
    want = synth.synthesize(_requests(SynthesisRequest), max_gen_len=16)
    got = cb.run(_requests(SynthesisRequest))
    assert min(r.frames for r in want) < 8
    for a, b in zip(got, want):
        assert a.frames == b.frames and np.array_equal(a.codes, b.codes)
    s = cb.last_stats
    assert s["steps"] < s["steps_planned"]


def test_prepare_refuses_a_request_alone():
    """``prepare`` refuses one request with its HTTP status: text past
    ``text_pad`` 413; a symbol outside the table, prompt codes of another
    width or out of range, and a wav that cannot be read 400; both
    engines; a good request prepares."""
    _, cb, synth = _batchers("lpt")
    ok = SynthesisRequest(text="fine", prompt_codes=np.zeros((3, 8)))
    assert cb.prepare(ok).prompt_codes.shape == (3, 8)
    cases = [(SynthesisRequest(text="a" * 40), 413),
             (SynthesisRequest(text="a1b"), 400),
             (SynthesisRequest(text="x", prompt_codes=np.zeros((3, 4))),
              400),
             (SynthesisRequest(text="x", prompt_codes=np.full((3, 8),
                                                              1024)), 400),
             (SynthesisRequest(text="x", prompt_wav="/nonexistent.wav"),
              400)]
    for req, code in cases:
        for engine in (cb, synth):
            if code == 413 and engine is synth:   # no text width
                continue
            with pytest.raises(RequestError) as ei:
                engine.prepare(req)
            assert ei.value.http_status == code, (req, engine)


def test_continuous_batcher_refusals():
    """Oversized text raises ValueError (JAX's contract); a mesh whose
    data axis does not divide the slots and one with a model axis (JAX's
    messages), VALL-F (JAX's message), a card that is not there and an
    unknown admission are refused."""
    _, _, model = make_pair(**TINY)
    args = (model, TextTokenizer(backend="char"),
            TextTokenCollater(sorted(set("abc "))), AudioTokenizer(
                device="cpu"))
    cb = ContinuousBatcher(*args, slots=1, text_pad=8, prompt_pad=8,
                           max_gen_len=8, device="cpu")
    with pytest.raises(ValueError, match="text_pad"):
        cb.run([SynthesisRequest(text="a" * 50)])
    with pytest.raises(ValueError, match="divisible"):
        ContinuousBatcher(*args, slots=3, mesh=make_mesh(
            dp=2, devices=["cpu", "cpu"]), device="cpu")
    with pytest.raises(ValueError, match="DP-only"):
        ContinuousBatcher(*args, slots=4, mesh=Mesh(
            [torch.device("cpu")] * 4, tp=2), device="cpu")
    vallf = VALLE(ValleConfig(**TINY, model_name="vallf"))
    with pytest.raises(ValueError, match="continuous batching targets VALLE"):
        ContinuousBatcher(vallf, *args[1:], device="cpu")
    with pytest.raises(ValueError, match="admission"):
        ContinuousBatcher(*args, admission="random", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatcher(*args)


def test_cb_step_applies_alpha():
    """alpha != 1 (C4): the CB step embeds ``alpha * pe`` as the port's
    ``valle_ar_decode`` does, so greedy codes equal it; JAX's CB step adds
    the bare PE row, so its logits after a chunk differ from the port's
    while the prefill's agree."""
    jcfg, params, model = make_pair(**TINY)
    with torch.no_grad():
        model.ar_audio_position.alpha.fill_(0.7)
    jparams = jax.tree_util.tree_map(lambda a: a, params)
    jparams["ar"]["audio_pe"] = {"alpha": jnp.full((1,), 0.7, jnp.float32)}
    cfg, B, G = model.cfg, 2, 12
    x = _inputs(2, B)
    args = [t(x[n]) for n in ("text", "text_lens", "prompts", "p_lens")]
    ref = valle_ar_decode(model, *args, top_k=1, max_gen_len=G)
    cache_len = S + P + G + 1
    st = pcb.cb_state_init(cfg, slots=B, cache_len=cache_len, max_gen_len=G,
                           device="cpu")
    k, v, lg = pcb.cb_prefill(model, *args, cache_len=cache_len)
    pcb.cb_install_many(st, torch.arange(B), k, v, lg, args[1], args[3])
    jst = jcb.cb_state_init(jcfg, slots=B, cache_len=cache_len,
                            max_gen_len=G, rng=jax.random.PRNGKey(0))
    jk, jv, jlg = jcb.cb_prefill(
        jparams, jcfg, *(jnp.asarray(x[n]) for n in
                         ("text", "text_lens", "prompts", "p_lens")),
        cache_len=cache_len)
    _close("logits0", lg, jlg)
    jst = jcb.cb_install_many(jst, jnp.arange(B), jk, jv, jlg,
                              jnp.asarray(x["text_lens"]),
                              jnp.asarray(x["p_lens"]))
    pcb.cb_decode_chunk(model, st, 1.0, S=S, K=1, top_k=1)
    jst = jcb.cb_decode_chunk(jparams, jst, 1.0, cfg=jcfg, S=S, K=1, top_k=1)
    gap = np.abs(st["logits"].numpy() - np.asarray(jst["logits"])).max()
    assert gap > 1e-3 * np.abs(np.asarray(jst["logits"])).max()
    while not bool(st["done"].all()):
        pcb.cb_decode_chunk(model, st, 1.0, S=S, K=4, top_k=1)
    assert torch.equal(st["gen_lens"], ref[1])
    assert torch.equal(st["gen_codes"], ref[0])
