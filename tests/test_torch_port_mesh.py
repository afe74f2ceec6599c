"""Serving over several devices in the port (``parallel.mesh.make_mesh``,
``Synthesizer(mesh=...)``, ``ContinuousBatcher(mesh=...)``, ``serve
--dp``) against the JAX package's mesh engines and the port's own
mesh=None engines, on the CPU at fp32. The port's two-shard mesh is
``["cpu", "cpu"]``: two threads sharing one replica, its stand-in for
the virtual CPU devices ``tests/conftest.py`` gives JAX."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.data import AudioTokenizer as JaxAudioTokenizer
from valle_tpu.data import TextTokenizer as JaxTextTokenizer
from valle_tpu.data.collation import TextTokenCollater as JaxCollater
from valle_tpu.models import ValleModel
from valle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from valle_tpu.serving import SynthesisRequest as JaxRequest
from valle_tpu.serving import Synthesizer as JaxSynthesizer
from valle_tpu_torch.bin import serve
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.ops.sampling import RowDraws, categorical
from valle_tpu_torch.parallel.mesh import Mesh, make_mesh
from valle_tpu_torch.serving import (ContinuousBatcher, SynthesisRequest,
                                     Synthesizer, resolve_mesh_decode_mode)
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict)

from torch_port_helpers import make_pair

SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
TINY = dict(d_model=32, nhead=2, num_layers=2, max_prefix_len=8)
TEXTS = ("hello there", "one more", "third request text", "tiny",
         "fifth and final sentence", "six", "seventh request",
         "the eighth and longest of all", "nine", "ten closes it")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(**kw):
    """A port VALL-E with seeded weights (the tests that hold the port
    against itself need no JAX tree)."""
    cfg = ValleConfig(**{**TINY, "prefix_mode": 1, **kw})
    return VALLE(cfg, generator=torch.Generator().manual_seed(0)).eval()


def _cpu_mesh(dp=2):
    return make_mesh(dp=dp, devices=["cpu"] * dp)


def _requests(cls, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(text=t, prompt_codes=rng.randint(0, 1024, (5, 8)))
            for t in TEXTS[:n]]


def _same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.frames == b.frames
        assert np.array_equal(a.codes, b.codes)


def _port_synth(model, audio_tok, **kw):
    return Synthesizer(model, TextTokenizer(backend="char"),
                       TextTokenCollater(SYMBOLS), audio_tok,
                       compute_dtype=torch.float32, codec_dtype="float32",
                       device="cpu", **kw)


def _end_by_eos(model, audio_tok):
    """Make lanes end by EOS at varied steps: the AR head's EOS row becomes
    a little over the row of a token that greedy decoding emits now and
    then (the fourth most frequent of a greedy run)."""
    ref = _port_synth(model, audio_tok, top_k=1, max_gen_len=48).synthesize(
        _requests(SynthesisRequest, 4), max_gen_len=48)
    vals, counts = np.unique(np.concatenate([r.codes[:, 0] for r in ref]),
                             return_counts=True)
    tok = int(vals[np.argsort(-counts, kind="stable")[3]])
    with torch.no_grad():
        w = model.ar_predict_layer.weight
        w[model.cfg.eos_id] = 1.02 * w[tok]


@pytest.mark.parametrize("decode_mode", ["exact", "fused"])
def test_mesh_synthesizer_matches_jax_mesh(decode_mode):
    """fp32 greedy codes of a two-shard port mesh equal a two-device JAX
    mesh's (GSPMD in "exact", shard_map over the Pallas kernels in
    "fused"): 3 requests snap to the grid's 4 (the pad row repeats request
    0), 2 rows a shard."""
    jcfg, params, model = make_pair(prefix_mode=1)
    jtok = JaxAudioTokenizer()
    jsynth = JaxSynthesizer(
        ValleModel(jcfg), params, JaxTextTokenizer(backend="char"),
        JaxCollater(SYMBOLS), jtok, top_k=1, max_gen_len=16,
        compute_dtype=jnp.float32, codec_dtype="float32",
        decode_mode=decode_mode,
        mesh=jax_make_mesh(dp=2, tp=1, devices=jax.devices()[:2]))
    tok = AudioTokenizer(device="cpu")
    load_numpy_state_dict(tok.codec, encodec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtok.params)))
    synth = _port_synth(model, tok, top_k=1, max_gen_len=16,
                        decode_mode=decode_mode, mesh=_cpu_mesh())
    ref = jsynth.synthesize(_requests(JaxRequest), max_gen_len=12)
    out = synth.synthesize(_requests(SynthesisRequest), max_gen_len=12)
    _same(out, ref)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=1e-4)
    assert synth.last_decode_mode == decode_mode


def test_mesh_synthesizer_sampled_exact_equals_one_device():
    """Sampled "exact" codes (top_k 5) of the two-shard mesh equal
    mesh=None's from the same seed, call after call, with lanes that end
    by EOS at different steps (so the shards stop apart and their
    generators are brought level after each call), and for 1 request,
    which the mesh pads to a row a shard; greedy "fused" codes too. The
    kernel modes fork a generator a shard, as JAX does."""
    model = _port_model(d_model=128, nhead=4)
    tok = AudioTokenizer(device="cpu")
    _end_by_eos(model, tok)
    for mode, top_k in (("exact", 5), ("fused", 1)):
        one = _port_synth(model, tok, top_k=top_k, max_gen_len=48,
                          decode_mode=mode, seed=7)
        two = _port_synth(model, tok, top_k=top_k, max_gen_len=48,
                          decode_mode=mode, seed=7, mesh=_cpu_mesh())
        lens = []
        for lo, hi in ((0, 3), (3, 7), (7, 8)):
            reqs = _requests(SynthesisRequest, 10)[lo:hi]
            ref = one.synthesize(reqs, max_gen_len=48)
            _same(two.synthesize(reqs, max_gen_len=48), ref)
            lens += [r.frames for r in ref]
        assert len(set(lens)) > 1, lens
    assert two._shards.shards[0].generator.initial_seed() != \
        two._shards.shards[1].generator.initial_seed()


def test_mesh_decode_mode_rule_matches_jax():
    """Each shard's decode mode is JAX's mesh rule (``_mesh_kernel_
    inference``): "auto" against the shard's rows, and at B % 8 != 0 every
    mode that groups rows by 8 as "fused" (one device's rule sends some
    to "exact"). JAX's mode is read from the valle_inference call its
    shard_map traces."""
    import valle_tpu.models as jmodels

    jcfg, params, model = make_pair()
    cfg = model.cfg
    seen = []

    def spy(params, cfg, text, tl, pr, pl, *, decode_mode, max_gen_len,
            nar_attn_impl, **kw):
        seen.append((decode_mode, nar_attn_impl))
        B = text.shape[0]
        return (jnp.zeros((B, max_gen_len, 8), jnp.int32),
                jnp.zeros((B,), jnp.int32))

    real = jmodels.valle_inference
    jmodels.valle_inference = spy
    try:
        for mode in ("auto", "int8", "fused_int8", "bf16", "fused_kv",
                     "lanes", "fused_lanes", "mega", "fused", "fused_w8"):
            for dp, B, P in ((2, 8, 32), (2, 16, 600), (2, 16, 32),
                             (4, 8, 600)):
                jsynth = JaxSynthesizer(
                    ValleModel(jcfg), params, None, None, None,
                    decode_mode=mode, compute_dtype=jnp.float32,
                    mesh=jax_make_mesh(dp=dp, tp=1,
                                       devices=jax.devices()[:dp]))
                S, G = 32, 64
                batch = (jnp.zeros((B, S), jnp.int32),
                         jnp.ones((B,), jnp.int32),
                         jnp.zeros((B, P, 8), jnp.int32),
                         jnp.ones((B,), jnp.int32),
                         jnp.full((B,), 2, jnp.int32))
                jsynth._mesh_kernel_inference(batch, G,
                                              jax.random.PRNGKey(0))
                got = resolve_mesh_decode_mode(mode, cfg, B=B // dp, S=S,
                                               P=P, max_gen_len=G)
                assert got == seen[-1][0], (mode, dp, B, P, got, seen[-1])
    finally:
        jmodels.valle_inference = real
    # "exact" and "unroll" keep their mode on a mesh
    assert resolve_mesh_decode_mode("exact", cfg, B=4, S=32, P=32,
                                    max_gen_len=64) == "exact"
    assert {m for m, _ in seen} >= {"fused", "int8", "mega", "fused_w8"}


def test_mesh_continuous_batcher_equals_one_device():
    """A two-shard slot table (slots 4, chunk 4) gives mesh=None's
    results, greedy and sampled (top_k 10; twice in a row), for 10
    requests through recycled slots (JAX's
    ``test_cb_dp_mesh_matches_single_device``), with lanes that end by EOS
    at different steps."""
    model = _port_model()
    tok = AudioTokenizer(device="cpu")
    _end_by_eos(model, tok)
    reqs = _requests(SynthesisRequest, 10, seed=1)
    kw = dict(slots=4, text_pad=32, prompt_pad=8, max_gen_len=32, chunk=4,
              compute_dtype=torch.float32, seed=11, device="cpu")
    args = (model, TextTokenizer(backend="char"), TextTokenCollater(SYMBOLS),
            tok)
    for top_k, runs in ((1, 1), (10, 2)):
        one = ContinuousBatcher(*args, top_k=top_k, **kw)
        two = ContinuousBatcher(*args, top_k=top_k, mesh=_cpu_mesh(), **kw)
        for _ in range(runs):
            ref = one.run(reqs)
            got = two.run(reqs)
            _same(got, ref)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=1e-5)
            assert two.last_stats["steps"] == one.last_stats["steps"]
        assert len({r.frames for r in ref}) > 1


def test_mesh_refusals():
    """JAX's refusals: slots that do not split over dp ("divisible"), a
    model axis in the CB ("DP-only") and in the Synthesizer; make_mesh
    refuses tp != 1 with a pointer, and a device count that is not dp."""
    model = _port_model()
    args = (model, TextTokenizer(backend="char"),
            TextTokenCollater(sorted(set("abc "))),
            AudioTokenizer(device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        ContinuousBatcher(*args, slots=3, mesh=_cpu_mesh(), device="cpu")
    tp2 = Mesh([torch.device("cpu")] * 4, tp=2)
    assert tp2.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="DP-only"):
        ContinuousBatcher(*args, slots=4, mesh=tp2, device="cpu")
    with pytest.raises(ValueError, match="whole weight matrices"):
        Synthesizer(*args, decode_mode="fused", mesh=tp2, device="cpu")
    with pytest.raises(ValueError, match="TP is out of scope"):
        Synthesizer(*args, decode_mode="exact", mesh=tp2, device="cpu")
    with pytest.raises(ValueError, match="TP is out of scope"):
        make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(dp=3, devices=["cpu", "cpu"])
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.devices == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(dp=1)


def test_row_draws_keep_the_whole_batch_draw():
    """A RowDraws draws what one generator drawing for the whole batch
    draws and keeps its rows: the categorical samples of rows 2..3 of 5
    equal the whole batch's, as do the generator's states after."""
    logits = torch.randn(5, 40, generator=torch.Generator().manual_seed(0))
    whole = torch.Generator().manual_seed(3)
    part = RowDraws(torch.Generator().manual_seed(3), 5, [2, 3])
    for _ in range(3):
        ref = categorical(logits, whole)
        got = categorical(logits[2:4], part)
        assert torch.equal(got, ref[2:4])
    assert part.draws == 3
    assert torch.equal(part.generator.get_state(), whole.get_state())


def test_serve_dp_over_http(tmp_path):
    """``serve --device cpu --dp 2`` builds a two-shard engine (static
    and continuous) that answers behind the HTTP worker; ``--slots`` that
    do not split over ``--dp`` exit with JAX's message."""
    model = _port_model()
    ckpt = tmp_path / "m.pt"
    torch.save({"model": model.state_dict(), "decoder_dim": 32, "nhead": 2,
                "num_decoder_layers": 2, "prefix_mode": 1}, ckpt)
    (tmp_path / "tokens.k2symbols").write_text("".join(
        f"{s} {i}\n" for i, s in enumerate(["<pad>"] + SYMBOLS)))
    base = ["--checkpoint", str(ckpt), "--text-tokens",
            str(tmp_path / "tokens.k2symbols"), "--text-backend", "char",
            "--max-gen-len", "8", "--device", "cpu", "--dp", "2"]
    with pytest.raises(SystemExit, match="divisible by --dp 2"):
        serve.main(base + ["--mode", "continuous", "--slots", "3"])
    for mode in ("static", "continuous"):
        flags = base + ["--mode", mode, "--slots", "2", "--text-pad", "32",
                        "--decode-mode", "exact"]
        fn, prep, info = serve.build_engine(serve.get_parser().parse_args(
            flags))
        assert info["dp"] == 2
        server, worker = serve.make_server(fn, port=0, info=info,
                                           prepare_fn=prep)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            for text in ("hi", "mesh"):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.server_address[1]}"
                    "/synthesize", data=json.dumps(
                        {"text": text, "codes_only": True,
                         "prompt_codes": np.zeros((4, 8), int).tolist()}
                    ).encode())
                with urllib.request.urlopen(req, timeout=120) as resp:
                    body = json.loads(resp.read())
                assert 0 < body["frames"] <= 8
                assert np.asarray(body["codes"]).shape == (body["frames"], 8)
        finally:
            server.shutdown()
            worker.stop()
            server.server_close()


def test_kernel_library_builds_once_across_threads(tmp_path, monkeypatch):
    """Shard threads that reach their first kernel together: one of them
    builds and loads the library under the lock (one compile a source,
    one link), the other waits and takes the same library. The toolchain
    and ``ctypes`` are stood in for (this host has no nvcc)."""
    import time
    import types

    from valle_tpu_torch.ops import cuda_build as cb

    runs = []

    def fake_run_all(cmds):
        runs.append([c[c.index("-o") + 1] for c in cmds])
        time.sleep(0.2)                  # hold the window open
        for c in cmds:
            open(c[c.index("-o") + 1], "w").close()

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cb, "_lib", None)
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cb, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cb, "_run_all", fake_run_all)
    monkeypatch.setattr(cb.ctypes, "CDLL", lambda path: FakeLib())
    got = [None, None]

    def load(i):
        got[i] = cb.load_library()

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert got[0] is not None and got[0] is got[1]
    n_src = len(list(cb.CSRC.glob("*.cu")))
    assert [len(r) for r in runs] == [n_src, 1]
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob("*.o"))


def test_launch_counts_by_shard_and_device_check(monkeypatch):
    """Launches counted from two shard threads land in ``LAUNCHES`` and in
    each shard's ``SHARD_LAUNCHES``; a launch on a card other than the
    thread's current device is refused before it runs."""
    import types

    from valle_tpu_torch.ops import cuda_build as cb

    saved = dict(cb.LAUNCHES)
    cb.reset_launch_counts()
    try:
        def work(i):
            with cb.shard_scope(i):
                for _ in range(100 * (i + 1)):
                    cb.count_launch("fused_tail")

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        cb.count_launch("fused_tail")        # outside any shard
        assert cb.LAUNCHES["fused_tail"] == 301
        assert {i: c["fused_tail"] for i, c in cb.SHARD_LAUNCHES.items()} \
            == {0: 100, 1: 200}
    finally:
        cb.reset_launch_counts()
        cb.LAUNCHES.update(saved)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        cb.stream_ptr(types.SimpleNamespace(device=torch.device("cuda", 1)))
