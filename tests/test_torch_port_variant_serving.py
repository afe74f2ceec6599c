"""The post-norm decode modes and serving with VALL-F, prenets and
post-norm stacks in the port on the CPU (fp32, greedy, 2 layers, d 128,
4 heads, the weights and statistics of ``make_variant``): the kernel
modes that take post-norm layers run their plain versions and give the
codes of "exact" (bf16, lanes, int8 through ``valle_inference``; grouped
and per_sample through ``valle_ar_decode``); every fused mode raises the
error that names it; the ContinuousBatcher with a prenet post-norm model
gives the Synthesizer's codes and refuses VALL-F with JAX's message, as
``bin/serve.py --mode continuous`` does at start-up; VALL-F's
Synthesizer runs "exact" whatever mode it is given."""

import numpy as np
import pytest
import torch

from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models.inference import valle_ar_decode, valle_inference
from valle_tpu_torch.serving import (ContinuousBatcher, SynthesisRequest,
                                     Synthesizer)

from torch_port_helpers import SLICE_ARGS, make_variant, slice_inputs, t

GEN = 40
SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the trainer tests run: beside the other
    test workers, many small ops on several threads each mostly wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codes(model, mode, rows=8):
    x = slice_inputs(rows=rows)
    codes, lens = valle_inference(model, *(t(x[n]) for n in SLICE_ARGS),
                                  top_k=1, max_gen_len=GEN, decode_mode=mode)
    return codes.numpy(), lens.numpy()


def test_post_norm_kernel_modes_give_exact_codes():
    """8 rows (JAX groups these modes by 8): bf16, lanes and int8 give
    exact's codes and lengths, and so do the transposed-cache modes'
    AR codes."""
    _, _, _, model = make_variant(norm_first=False)
    exact = _codes(model, "exact")
    for mode in ("bf16", "lanes", "int8"):
        got = _codes(model, mode)
        assert all(np.array_equal(a, b) for a, b in zip(got, exact)), mode
    x = slice_inputs(rows=8)
    for mode in ("grouped", "per_sample"):
        q0, lens = valle_ar_decode(
            model, *(t(x[n]) for n in ("text", "text_lens")),
            t(x["prompt_codes"][..., 0]), t(x["prompt_lens"]), top_k=1,
            max_gen_len=GEN, decode_mode=mode)
        assert np.array_equal(lens.numpy(), exact[1]), mode
        assert np.array_equal(q0.numpy(), exact[0][..., 0]), mode


@pytest.mark.parametrize("mode", ["fused", "fused_w8", "fused_int8",
                                  "fused_kv", "fused_lanes", "mega"])
def test_fused_modes_refuse_post_norm_in_synthesis(mode):
    """Every fused mode raises naming itself; none falls back."""
    _, _, _, model = make_variant(norm_first=False)
    with pytest.raises(ValueError, match=f"'{mode}'.*post-norm"):
        _codes(model, mode)


def _engines(model, **kw):
    args = (model, TextTokenizer(backend="char"), TextTokenCollater(SYMBOLS),
            AudioTokenizer(device="cpu"))
    common = dict(top_k=1, compute_dtype=torch.float32,
                  codec_dtype="float32", wav_transfer="float32",
                  device="cpu")
    synth = Synthesizer(*args, max_gen_len=16, **common, **kw)
    return args, common, synth


def _requests():
    rng = np.random.RandomState(0)
    return [SynthesisRequest(text=s, prompt_codes=rng.randint(0, 1024,
                                                              (5, 8)))
            for s in ("hello there", "one more", "third request text")]


def test_continuous_batcher_with_prenets_and_post_norm():
    """A prenet post-norm model through 2 slots gives the Synthesizer's
    codes request by request."""
    _, _, _, model = make_variant(add_prenet=True, norm_first=False,
                                  prefix_mode=1)
    args, common, synth = _engines(model)
    cb = ContinuousBatcher(*args, slots=2, text_pad=32, prompt_pad=8,
                           max_gen_len=16, chunk=4, **common)
    got = cb.run(_requests())
    want = synth.synthesize(_requests(), max_gen_len=16)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.frames == b.frames and np.array_equal(a.codes, b.codes)


def test_vallf_serving():
    """VALL-F: the Synthesizer runs its one path ("exact") whatever mode
    it is given; the ContinuousBatcher refuses it with JAX's message."""
    _, _, _, model = make_variant(model_name="vallf", prefix_mode=1)
    args, common, synth = _engines(model, decode_mode="fused")
    out = synth.synthesize(_requests()[:2], max_gen_len=16)
    assert synth.last_decode_mode == "exact"
    assert all(r.wav.shape == (r.frames * 320,) for r in out)
    with pytest.raises(ValueError, match="continuous batching targets "
                                         "VALLE"):
        ContinuousBatcher(*args, **common)


def test_serve_continuous_refuses_vallf_at_start(tmp_path):
    """``bin/serve.py --mode continuous`` with a VALL-F checkpoint fails
    while it builds its engine, with JAX's message; ``--mode static``
    builds."""
    from valle_tpu_torch.bin import serve
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.utils.symbol_table import SymbolTable

    model = VALLE(ValleConfig(d_model=64, nhead=4, num_layers=1,
                              model_name="vallf"))
    torch.save({"model": model.state_dict(), "model_name": "VALL-F",
                "decoder_dim": 64, "nhead": 4, "num_decoder_layers": 1},
               tmp_path / "m.pt")
    table = SymbolTable(eps=None)
    for i, c in enumerate(["<pad>", "<bos>", "<eos>"] + SYMBOLS):
        table.add(c, i)
    table.to_file(tmp_path / "tokens.k2symbols")
    argv = ["--checkpoint", str(tmp_path / "m.pt"), "--text-tokens",
            str(tmp_path / "tokens.k2symbols"), "--text-backend", "char",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="continuous batching targets "
                                         "VALLE"):
        serve.build_engine(serve.get_parser().parse_args(
            argv + ["--mode", "continuous"]))
    _, _, info = serve.build_engine(serve.get_parser().parse_args(
        argv + ["--mode", "static"]))
    assert info["model"] == "vallf"
