"""The port's audio library (``valle_tpu_torch.native``) against the JAX
package's (``valle_tpu.native``, the same C++ source): the same bits on
seeded signals, files written by one read back by the other, and a build
that fails raises."""

import numpy as np
import pytest

from valle_tpu import native as jax_native
from valle_tpu_torch import native


def _signal(n, channels=None, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16_000.0
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)
    if channels:
        x = np.stack([x * (c + 1) / channels for c in range(channels)], 1)
    return np.clip(x, -1, 1).astype(np.float32)


@pytest.mark.parametrize("bits", [16, 32])
def test_wav_round_trip_and_cross_read(tmp_path, bits):
    """A file written by either library reads back the same in both, and
    the port writes the JAX library's bytes."""
    x = _signal(3001, channels=2, seed=bits)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    native.write_wav(ours, x, 16_000, bits=bits)
    jax_native.write_wav(theirs, x, 16_000, bits=bits)
    assert ours.read_bytes() == theirs.read_bytes()
    for path in (ours, theirs):
        a, sr_a = native.read_wav(path)
        b, sr_b = jax_native.read_wav(path)
        assert sr_a == sr_b == 16_000 and a.shape == (3001, 2)
        np.testing.assert_array_equal(a, b)
    # PCM16 writes round(x * 32767) and reads s / 32768: half a step of
    # rounding plus the scale mismatch, at most 1.5 / 32767 for |x| <= 1
    y, _ = native.read_wav(ours)
    np.testing.assert_allclose(y, x, rtol=0,
                               atol=0 if bits == 32 else 1.5 / 32767)


def test_to_mono_matches():
    x = _signal(777, channels=3, seed=1)
    np.testing.assert_array_equal(native.to_mono(x), jax_native.to_mono(x))
    np.testing.assert_allclose(native.to_mono(x), x.mean(1), rtol=1e-6)
    mono = x[:, 0]
    assert native.to_mono(mono) is mono
    np.testing.assert_array_equal(native.to_mono(x[:, :1]), x[:, 0])


@pytest.mark.parametrize("sr_in", [16_000, 44_100, 24_000])
def test_resample_and_convert_bit_equal(sr_in):
    """resample and convert_audio to 24 kHz give the JAX library's bits
    (Kaiser windowed sinc, zeros 24, rolloff 0.945)."""
    x = _signal(sr_in // 4, seed=2)
    ours = native.resample(x, sr_in, 24_000)
    theirs = jax_native.resample(x, sr_in, 24_000)
    assert ours.dtype == np.float32
    assert abs(len(ours) - 6000) <= 1
    np.testing.assert_array_equal(ours, theirs)
    stereo = _signal(sr_in // 5, channels=2, seed=3)
    np.testing.assert_array_equal(
        native.convert_audio(stereo, sr_in, 24_000),
        jax_native.convert_audio(stereo, sr_in, 24_000))
    np.testing.assert_array_equal(
        native.convert_audio(stereo, sr_in, 24_000, channels_out=2),
        jax_native.convert_audio(stereo, sr_in, 24_000, channels_out=2))


def test_library_builds_into_build_dir_and_failed_build_raises(
        tmp_path, monkeypatch):
    lib_path = native._build()
    assert lib_path.parent == native.BUILD_DIR
    assert lib_path.parts[-3:-1] == ("build", "valle_tpu_torch")
    # a fresh build directory and a compiler that cannot run: no fallback
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="audio library build failed"):
        native._build()
    with pytest.raises(IOError):
        native.read_wav(tmp_path / "missing.wav")
