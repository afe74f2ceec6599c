"""``valle_continual`` and a Synthesizer batch with ``prompt_wav``s, the
port against the JAX package on the CPU at fp32: codes and lengths
bit-equal (greedy, ``top_k=1``, for the Synthesizer)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from valle_tpu import native as jax_native
from valle_tpu.data import AudioTokenizer as JaxAudioTokenizer
from valle_tpu.data import TextTokenizer as JaxTextTokenizer
from valle_tpu.data.collation import TextTokenCollater as JaxCollater
from valle_tpu.models import ValleModel
from valle_tpu.models.inference import valle_continual as jax_continual
from valle_tpu.serving import SynthesisRequest as JaxRequest
from valle_tpu.serving import Synthesizer as JaxSynthesizer
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models.inference import valle_continual
from valle_tpu_torch.serving import SynthesisRequest, Synthesizer

from torch_port_helpers import make_pair, mirror_state_dict, slice_inputs, t
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))


@pytest.mark.parametrize("prefix_mode,prepend_bos",
                         [(0, False), (1, False), (2, False), (4, False),
                          (1, True)], ids=["0", "1", "2", "4", "1-bos"])
def test_continual_matches_jax(prefix_mode, prepend_bos):
    """B 2 with unequal y_lens (24 and 17 frames: a prefix of 8), in each
    NAR prefix mode, and with <BOS> before the AR inputs."""
    jcfg, params, model = make_pair(prefix_mode=prefix_mode,
                                    prepend_bos=prepend_bos)
    x = slice_inputs(seed=4)
    rng = np.random.RandomState(6)
    y = rng.randint(0, 1024, (2, 24, 8)).astype(np.int32)
    y_lens = np.array([24, 17], np.int32)
    jcodes, jlens = jax_continual(params, jcfg, jnp.asarray(x["text"]),
                                  jnp.asarray(x["text_lens"]),
                                  jnp.asarray(y), jnp.asarray(y_lens))
    codes, lens = valle_continual(model, t(x["text"]), t(x["text_lens"]),
                                  t(y), t(y_lens))
    assert lens.dtype == torch.int32 and codes.shape == (2, 24, 8)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(lens.numpy(), y_lens - 8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    # quantizer 0 is the utterance's past the prefix
    np.testing.assert_array_equal(codes[1, :9, 0].numpy(), y[1, 8:17, 0])


def test_synthesizer_with_prompt_wavs_matches_jax(tmp_path):
    """Three requests, two with 16 kHz prompt wavs that the codec encodes
    (one with prompt text), one without a prompt."""
    weights = tmp_path / "encodec.th"
    torch.save(mirror_state_dict(), weights)
    rng = np.random.RandomState(8)
    wavs = []
    for i, n in enumerate((4800, 3300)):
        tt = np.arange(n) / 16_000.0
        w = (0.3 * np.sin(2 * np.pi * (200 + 90 * i) * tt)
             + 0.05 * rng.randn(n)).astype(np.float32)
        wavs.append(tmp_path / f"p{i}.wav")
        jax_native.write_wav(wavs[-1], w, 16_000)

    def requests(cls):
        return [cls(text="hello world", prompt_wav=str(wavs[0])),
                cls(text="a longer different sentence",
                    prompt_text="prompt words", prompt_wav=str(wavs[1])),
                cls(text="short")]

    jcfg, params, model = make_pair(prefix_mode=1)
    jsynth = JaxSynthesizer(
        ValleModel(jcfg), params, JaxTextTokenizer(backend="char"),
        JaxCollater(SYMBOLS), JaxAudioTokenizer(weights_path=str(weights)),
        top_k=1, max_gen_len=32, compute_dtype=jnp.float32,
        codec_dtype="float32")
    synth = Synthesizer(
        model, TextTokenizer(backend="char"), TextTokenCollater(SYMBOLS),
        AudioTokenizer(weights_path=str(weights), device="cpu"), top_k=1,
        max_gen_len=32, compute_dtype=torch.float32, codec_dtype="float32",
        device="cpu")
    ref = jsynth.synthesize(requests(JaxRequest), max_gen_len=16)
    out = synth.synthesize(requests(SynthesisRequest), max_gen_len=16)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.frames == b.frames
        np.testing.assert_array_equal(a.codes, b.codes)
        assert a.wav.shape == (a.frames * 320,)
        np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=5e-4)
