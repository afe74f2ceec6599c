"""The port's EnCodec encoder against the JAX package's on the CPU: SEANet
latents, RVQ codes, ``encodec_encode``, the importer of encodec-package
weights, ``AudioTokenizer(weights_path=...)`` and ``AudioTokenExtractor``.

The wav is ``tests/test_codec_torch_parity.py``'s (2 x 8000 samples, not a
multiple of the 320 hop). Limits: latents rtol 1e-4 / atol 2e-4 and
decoded wavs atol 5e-4, the limits of ``test_codec_torch_parity.py``;
codes bit-equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.codec import quantization as jax_rvq
from valle_tpu.codec import seanet as jax_seanet
from valle_tpu.codec.convert import (
    import_encodec_state_dict as jax_import_encodec_state_dict)
from valle_tpu.codec.model import EncodecConfig as JaxEncodecConfig
from valle_tpu.codec.model import encodec_decode as jax_encodec_decode
from valle_tpu.codec.model import encodec_encode as jax_encodec_encode
from valle_tpu.codec.model import init_encodec
from valle_tpu.data.tokenizer import (
    AudioTokenExtractor as JaxAudioTokenExtractor)
from valle_tpu_torch.codec.convert import (import_encodec_state_dict,
                                           load_encodec_torch)
from valle_tpu_torch.codec.model import (EncodecModel, encodec_decode,
                                         encodec_encode)
from valle_tpu_torch.codec.quantization import rvq_encode
from valle_tpu_torch.codec.seanet import seanet_encoder_apply
from valle_tpu_torch.data.tokenizer import (AudioTokenExtractor,
                                            AudioTokenizer,
                                            compute_num_frames)
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict)

from torch_port_helpers import jit_init, mirror_state_dict
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

JCFG = JaxEncodecConfig()


@functools.lru_cache(maxsize=None)
def _jax_codec():
    params = jit_init(init_encodec, 0, JCFG)
    model = EncodecModel()
    load_numpy_state_dict(model, encodec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model.eval()


def parity_wav():
    rng = np.random.RandomState(3)
    T = 8000
    t = np.arange(T) / 24000.0
    w = (0.4 * np.sin(2 * np.pi * 220 * t)[None, :]
         + 0.2 * np.sin(2 * np.pi * 917 * t)[None, :]
         + 0.05 * rng.randn(2, T)).astype(np.float32)
    w[1] *= 0.3
    return np.clip(w, -1, 1)


def test_encoder_latents_rvq_and_codes_match_jax():
    params, model = _jax_codec()
    wav = parity_wav()
    jlat = np.array(jax_seanet.seanet_encoder_apply(
        params["encoder"], jnp.asarray(wav[:, :, None])))
    with torch.no_grad():
        lat = seanet_encoder_apply(model.encoder,
                                   torch.from_numpy(wav)[:, :, None])
    assert lat.shape == jlat.shape == (2, 25, 128)
    np.testing.assert_allclose(lat.numpy(), jlat, rtol=1e-4, atol=2e-4)
    # RVQ on identical latents: bit-equal
    jcodes = np.asarray(jax_rvq.rvq_encode(params["quantizer"],
                                           jnp.asarray(jlat), 8))
    codes = rvq_encode(model.quantizer, torch.from_numpy(jlat), 8)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    # the whole encode: bit-equal
    jcodes = np.asarray(jax_encodec_encode(
        params, jnp.asarray(wav[:, :, None]), cfg=JCFG, n_q=8))
    codes = encodec_encode(model, torch.from_numpy(wav)[:, :, None])
    assert codes.shape == (2, 25, 8)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    with pytest.raises(ValueError, match="float32"):
        encodec_encode(model, torch.from_numpy(wav)[:, :, None].double())


def test_importer_matches_jax_importer(tmp_path):
    """A weight-normed encodec state dict through the port's importer and
    through JAX's: the same codes, decoded wavs within 5e-4. The "model"
    sub-dict form, the codebooks' training buffers and a file on disk
    load too; a missing key fails the strict load."""
    sd = mirror_state_dict()
    jparams = jax_import_encodec_state_dict(sd)
    model = EncodecModel()
    model.load_state_dict(import_encodec_state_dict(sd), strict=True)
    wav = parity_wav()[:, :, None]
    jcodes = jax_encodec_encode(jparams, jnp.asarray(wav), cfg=JCFG, n_q=8)
    codes = encodec_encode(model, torch.from_numpy(wav))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    jwav = np.asarray(jax_encodec_decode(jparams, jcodes, cfg=JCFG))
    out = encodec_decode(model, codes)
    np.testing.assert_allclose(out.numpy(), jwav, rtol=0, atol=5e-4)

    extra = {f"quantizer.vq.layers.0._codebook.{n}": torch.zeros(3)
             for n in ("inited", "cluster_size", "embed_avg")}
    path = tmp_path / "encodec.th"
    torch.save({"model": {**sd, **extra}}, path)
    loaded = load_encodec_torch(str(path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    partial = {k: v for k, v in sd.items() if not k.startswith("encoder.")}
    with pytest.raises(RuntimeError, match="Missing key"):
        EncodecModel().load_state_dict(import_encodec_state_dict(partial),
                                       strict=True)


def test_audio_tokenizer_weights_and_extractor_match_jax(tmp_path,
                                                         monkeypatch):
    """``AudioTokenizer`` loads weights from a path or from
    VALLE_TPU_ENCODEC_WEIGHTS; ``AudioTokenExtractor.extract`` and
    ``extract_batch`` on 16 kHz input equal JAX's frame for frame."""
    path = tmp_path / "encodec.th"
    torch.save(mirror_state_dict(), path)
    assert not AudioTokenizer(device="cpu").pretrained
    monkeypatch.setenv("VALLE_TPU_ENCODEC_WEIGHTS", str(path))
    tok = AudioTokenizer(device="cpu")
    assert tok.pretrained and tok.n_q == 8
    monkeypatch.delenv("VALLE_TPU_ENCODEC_WEIGHTS")

    ours = AudioTokenExtractor(weights_path=str(path), device="cpu")
    theirs = JaxAudioTokenExtractor(weights_path=str(path))
    rng = np.random.RandomState(5)
    t = np.arange(5000) / 16_000.0
    a = (0.3 * np.sin(2 * np.pi * 300 * t)
         + 0.05 * rng.randn(5000)).astype(np.float32)
    b = a[:3777] * 0.5
    got, want = ours.extract(a, 16_000), theirs.extract(a, 16_000)
    assert got.dtype == np.int16
    assert got.shape == (compute_num_frames(5000 / 16_000, 320 / 24000,
                                            24_000), 8)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(ours.extract_batch([a, b], 16_000),
                    theirs.extract_batch([a, b], 16_000)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_encode_runs_without_tf32_and_restores_the_settings():
    """encodec_encode switches TF32 off for cuDNN and matmuls while the
    encoder runs (seen from a hook on the encoder) and gives the caller's
    settings back, also when the encode raises."""
    _, model = _jax_codec()
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = []
    hook = model.encoder.register_forward_hook(
        lambda mod, inp, out: seen.append((cudnn.allow_tf32, mm.allow_tf32)))
    prev = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = True
    try:
        encodec_encode(model, torch.from_numpy(parity_wav())[:, :, None])
        assert seen == [(False, False)]
        assert (cudnn.allow_tf32, mm.allow_tf32) == (True, True)
        with pytest.raises(RuntimeError):
            encodec_encode(model, torch.zeros(1, 400, 2))
        assert (cudnn.allow_tf32, mm.allow_tf32) == (True, True)
    finally:
        hook.remove()
        cudnn.allow_tf32, mm.allow_tf32 = prev
