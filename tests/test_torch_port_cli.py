"""``python -m valle_tpu_torch.bin.infer`` against ``valle_tpu.bin.infer``
on the CPU: the same reference-format ``.pt`` (written here from
``valle_tpu/utils/checkpoint.py:189 export_torch_state_dict``), the same
encodec-package codec weights (``tests/encodec_torch_mirror.py``), the same
16 kHz prompt wav and ``--top-k 1``. The wavs both write have the same
length and agree within the codec-decode limit (5e-4, as in
``test_codec_torch_parity.py``) plus one PCM16 step."""

import sys

import numpy as np
import pytest
import torch

import jax

from valle_tpu.bin import infer as jax_infer
from valle_tpu.utils.checkpoint import export_torch_state_dict
from valle_tpu_torch import native
from valle_tpu_torch.bin import infer
from valle_tpu_torch.serving import SynthesisRequest, Synthesizer
from valle_tpu_torch.utils.convert import valle_state_dict_from_jax
from valle_tpu_torch.utils.symbol_table import SymbolTable

from torch_port_helpers import make_pair, mirror_state_dict
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

HPARAMS = {"model_name": "VALL-E", "decoder_dim": 128, "nhead": 4,
           "num_decoder_layers": 2, "norm_first": True, "add_prenet": False,
           "prefix_mode": 1, "share_embedding": True, "scale_factor": 1.0,
           "prepend_bos": False, "num_quantizers": 8}
WAV_ATOL = 5e-4 + 1 / 32767


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(.pt checkpoint, symbol table, codec weights, prompt wav)."""
    d = tmp_path_factory.mktemp("cli")
    table = SymbolTable(eps=None)
    for i, s in enumerate(["<pad>", "<bos>", "<eos>"] + sorted(
            set("abcdefghijklmnopqrstuvwxyz_!.?"))):
        table.add(s, i)
    tokens = d / "unique_text_tokens.k2symbols"
    table.to_file(tokens)
    jcfg, params, _ = make_pair(prefix_mode=1)
    sd = export_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, params), jcfg)
    ckpt = d / "epoch-1.pt"
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()},
                "text_tokens": str(tokens), **HPARAMS}, ckpt)
    codec = d / "encodec.th"
    torch.save(mirror_state_dict(), codec)
    rng = np.random.RandomState(9)
    tt = np.arange(4000) / 16_000.0
    wav = (0.3 * np.sin(2 * np.pi * 220 * tt)
           + 0.05 * rng.randn(4000)).astype(np.float32)
    prompt = d / "prompt.wav"
    native.write_wav(prompt, wav, 16_000)
    return ckpt, tokens, codec, prompt


def _argv(files, out_dir, text, extra=()):
    ckpt, tokens, codec, prompt = files
    return ["--checkpoint", str(ckpt), "--text-tokens", str(tokens),
            "--encodec-weights", str(codec), "--text-extractor", "char",
            "--text-prompts", "hello there", "--audio-prompts", str(prompt),
            "--text", text, "--top-k", "1", "--max-gen-len", "24",
            "--output-dir", str(out_dir), *extra]


def _run_both(monkeypatch, tmp_path, argv_of):
    monkeypatch.setenv("VALLE_TPU_COMPILATION_CACHE", "off")
    monkeypatch.setattr(sys, "argv", ["infer"] + argv_of(tmp_path / "jax"))
    jax_infer.main()
    infer.main(argv_of(tmp_path / "port") + ["--device", "cpu"])


def _assert_same_wav(a, b):
    wa, sra = native.read_wav(a)
    wb, srb = native.read_wav(b)
    assert sra == srb == 24_000
    assert wa.shape == wb.shape and wa.shape[0] % 320 == 0
    assert np.isfinite(wa).all()
    np.testing.assert_allclose(wa, wb, rtol=0, atol=WAV_ATOL)


@pytest.mark.parametrize("mode", ["plain", "continual"])
def test_cli_writes_jax_cli_wavs(files, tmp_path, monkeypatch, mode):
    extra = ("--continual", "true") if mode == "continual" else ()
    _run_both(monkeypatch, tmp_path, lambda out: _argv(
        files, out, "testing now|another one", extra))
    for n in (0, 1):
        _assert_same_wav(tmp_path / "port" / f"{n}.wav",
                         tmp_path / "jax" / f"{n}.wav")


def _run_tsv(files, tmp_path, monkeypatch, extra=()):
    prompt = files[3]
    tsv = {}
    for side in ("jax", "port"):
        lines = [f"hello there\t{prompt}\ttesting now\t"
                 f"{tmp_path / side / 'a.wav'}",
                 f"a prompt\t{prompt}\tanother line\t"
                 f"{tmp_path / side / 'b.wav'}"]
        tsv[side] = tmp_path / f"{side}.tsv"
        tsv[side].write_text("\n".join(lines) + "\n")
    _run_both(monkeypatch, tmp_path, lambda out: _argv(
        files, tmp_path / "unused", str(tsv[out.name]), extra))
    for name in ("a.wav", "b.wav"):
        _assert_same_wav(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_cli_tsv_mode_writes_jax_cli_wavs(files, tmp_path, monkeypatch):
    _run_tsv(files, tmp_path, monkeypatch)


def test_cli_tsv_mode_ignores_continual(files, tmp_path, monkeypatch):
    """--continual does not apply to a TSV file, in either CLI: each line
    is synthesized from its text, so both write the same wavs."""
    _run_tsv(files, tmp_path, monkeypatch, ("--continual", "true"))


def test_load_model_and_from_checkpoint(files, tmp_path, monkeypatch):
    """load_model gives valle_state_dict_from_jax's tensors and the
    checkpoint's symbol table; flags fill what the checkpoint omits; an
    orbax directory and --device cuda without a card raise;
    Synthesizer.from_checkpoint runs a prompt-wav request."""
    ckpt, tokens, codec, prompt = files
    model, text_tokens = infer.load_model(str(ckpt), device="cpu")
    assert text_tokens == str(tokens)
    jcfg, params, _ = make_pair(prefix_mode=1)
    want = valle_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jcfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert model.cfg.prefix_mode == 1 and model.cfg.d_model == 128

    bare = tmp_path / "bare.pt"
    torch.save({"model": torch.load(ckpt, weights_only=False)["model"]},
               bare)
    args = infer.get_parser().parse_args(
        ["--decoder-dim", "128", "--nhead", "4", "--num-decoder-layers",
         "2", "--prefix-mode", "1"])
    assert args.decode_mode == "exact" and args.device == "cuda"
    model2, none = infer.load_model(str(bare), args, device="cpu")
    assert none is None and model2.cfg == model.cfg

    with pytest.raises(NotImplementedError,
                       match="valle_tpu_torch.bin.trainer"):
        infer.load_model(str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(_argv(files, tmp_path / "x", "hi"))

    synth = Synthesizer.from_checkpoint(
        str(ckpt), None, text_backend="char", encodec_weights=str(codec),
        device="cpu", top_k=1, compute_dtype=torch.float32)
    out = synth.synthesize([SynthesisRequest(text="testing",
                                             prompt_wav=str(prompt))],
                           max_gen_len=8)
    assert out[0].frames > 0 and out[0].wav.shape == (out[0].frames * 320,)


def test_model_arguments_and_get_model():
    """The port's parser takes the JAX CLI's flags with the same defaults;
    get_model builds the VALLE they describe (VALL-F, post-norm and
    prenet models too), and the Transformer TTS model (both
    --scaling-xformers settings, 100 mel bins)."""
    mine, theirs = infer.get_parser(), jax_infer.get_parser()
    jax_flags = {a.dest: a.default for a in theirs._actions}
    port_flags = {a.dest: a.default for a in mine._actions}
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert set(jax_flags) <= set(port_flags)
    assert all(port_flags[k] == v for k, v in jax_flags.items())

    from valle_tpu_torch.models import get_model

    args = mine.parse_args(["--decoder-dim", "64", "--nhead", "4",
                            "--num-decoder-layers", "1", "--prefix-mode",
                            "2", "--share-embedding", "false"])
    model = get_model(args, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert (model.cfg.d_model, model.cfg.nhead, model.cfg.num_layers,
            model.cfg.prefix_mode, model.cfg.share_embedding,
            model.cfg.attn_impl) == (64, 4, 1, 2, False, "einsum")
    small = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers",
             "1"]
    for flags, want in ((["--model-name", "VALL-F"], ("vallf", True, False)),
                        (["--norm-first", "false", "--add-prenet", "true"],
                         ("valle", False, True))):
        cfg = get_model(mine.parse_args(small + flags), device="cpu").cfg
        assert (cfg.model_name, cfg.norm_first, cfg.add_prenet) == want
    from valle_tpu_torch.models.transformer import TransformerTtsModel

    for sx in ("false", "true"):
        model = get_model(mine.parse_args(
            small + ["--model-name", "Transformer", "--scaling-xformers",
                     sx]), device="cpu")
        assert isinstance(model, TransformerTtsModel)
        assert (model.cfg.d_model, model.cfg.num_layers,
                model.cfg.num_mel_bins, model.cfg.scaling_xformers) == (
                    64, 1, 100, sx == "true")


@pytest.mark.parametrize("to_file", [False, True], ids=["console", "file"])
def test_setup_logger_prints_each_line_once(tmp_path, to_file):
    """The root logger holds one stderr handler, and one file handler when
    a log file is asked for: a line logged once is printed once."""
    import logging

    from valle_tpu_torch.utils import setup_logger

    root = logging.getLogger("")
    handlers, level = root.handlers[:], root.level
    try:
        setup_logger(str(tmp_path / "log" / "log-infer") if to_file else None)
        streams = [h for h in root.handlers
                   if type(h) is logging.StreamHandler]
        files = [h for h in root.handlers
                 if isinstance(h, logging.FileHandler)]
        assert len(streams) == 1 and streams[0].stream is sys.stderr
        assert len(files) == int(to_file)
        for h in files:
            h.close()
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
