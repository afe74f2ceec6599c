"""BigVGAN-compatible log-mel features (the Transformer mel model's input).

A copy of ``valle_tpu/data/fbank.py`` (numpy); resampling goes through
the port's ``native`` library.

Parity with reference ``valle/data/fbank.py``: 24 kHz, n_fft = win = 1024,
hop 256, 100 mel bins over 0..12 kHz, Hann window, center=False with
end-padding to the lhotse frame count, magnitude sqrt(re^2+im^2+1e-9),
Slaney-normalized librosa-style mel filterbank, log(clamp(x, 1e-5))
compression. ``extract`` is the host-side numpy version (one
utterance); ``extract_batch`` computes a batch on a torch device (the
offline tokenizer's path: frames, ``torch.fft.rfft`` and the mel product
in float64, as numpy's FFT computes), each utterance trimmed to its own
frame count.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .tokenizer import compute_num_frames

EPSILON = 1e-10


@dataclass
class BigVGANFbankConfig:
    frame_length: float = 1024 / 24000.0
    frame_shift: float = 256 / 24000.0
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    low_freq: float = 0.0
    high_freq: float = 12000.0
    num_mel_bins: int = 100
    use_energy: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "BigVGANFbankConfig":
        return BigVGANFbankConfig(**data)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(
        np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(
        logstep * (np.maximum(m, min_log_mel) - min_log_mel)), freqs)
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """librosa.filters.mel equivalent (slaney scale + slaney norm)."""
    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_min, mel_max = _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


class BigVGANFbank:
    name = "fbank"
    config_type = BigVGANFbankConfig

    def __init__(self, config: Optional[BigVGANFbankConfig] = None):
        self.config = config or BigVGANFbankConfig()
        self.sampling_rate = 24000
        self.n_fft = self.win_length = 1024
        self.hop = 256
        self.mel_basis = mel_filterbank(
            self.sampling_rate, self.n_fft, self.config.num_mel_bins,
            self.config.low_freq, self.config.high_freq)
        self.window = np.hanning(self.win_length + 1)[:-1].astype(np.float32)

    @property
    def frame_shift(self) -> float:
        return self.config.frame_shift

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_mel_bins

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        y = np.asarray(samples, np.float32).reshape(-1)
        if sampling_rate != self.sampling_rate:
            # recipes keep corpora at native rates (22.05 k / 16 k);
            # resample like the EnCodec extractor does instead of dying
            from .. import native

            y = native.resample(y, sampling_rate, self.sampling_rate)
            sampling_rate = self.sampling_rate
        expected = compute_num_frames(
            round(len(y) / sampling_rate, ndigits=12), self.frame_shift,
            sampling_rate)
        pad = (expected - 1) * self.hop + self.win_length - len(y)
        assert pad >= 0, pad
        y = np.pad(y, (0, pad))
        # framed STFT, center=False (reference fbank.py:113-124)
        idx = (np.arange(self.win_length)[None, :]
               + self.hop * np.arange(expected)[:, None])
        frames = y[idx] * self.window[None, :]
        spec = np.fft.rfft(frames, n=self.n_fft, axis=1)
        mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        mel = mag @ self.mel_basis.T  # (T, n_mels)
        return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)

    def _frames(self, n: int) -> int:
        return compute_num_frames(round(n / self.sampling_rate, ndigits=12),
                                  self.frame_shift, self.sampling_rate)

    def extract_batch(self, samples: List[np.ndarray], sampling_rate: int,
                      *, device="cpu") -> List[np.ndarray]:
        """``extract`` of each utterance, computed as one batch on
        ``device``: (T_i, num_mel_bins) float32 arrays."""
        from .. import native

        waves = []
        for w in samples:
            w = np.asarray(w, np.float32).reshape(-1)
            if sampling_rate != self.sampling_rate:
                w = native.resample(w, sampling_rate, self.sampling_rate)
            waves.append(w)
        frames = [self._frames(len(w)) for w in waves]
        width = (max(frames) - 1) * self.hop + self.win_length
        batch = np.zeros((len(waves), max(width, max(map(len, waves)))),
                         np.float32)
        for i, w in enumerate(waves):
            batch[i, :len(w)] = w
        # float64, as numpy's FFT: in fp32 the small mel bins' logs move
        # by ~1e-3 between two FFT libraries
        dev = torch.device(device)
        y = torch.as_tensor(batch, device=dev, dtype=torch.float64)
        fr = y.unfold(1, self.win_length, self.hop)[:, :max(frames)]
        win = torch.as_tensor(self.window, device=dev, dtype=torch.float32)
        spec = torch.fft.rfft(fr * win.double(), n=self.n_fft)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        mel = mag @ torch.as_tensor(self.mel_basis, device=dev).double().T
        out = torch.log(torch.clamp_min(mel, 1e-5)).float().cpu().numpy()
        return [out[i, :n] for i, n in enumerate(frames)]

    @staticmethod
    def mix(features_a, features_b, energy_scaling_factor_b):
        return np.log(np.maximum(
            EPSILON,
            np.exp(features_a) + energy_scaling_factor_b
            * np.exp(features_b)))

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))


def get_fbank_extractor() -> BigVGANFbank:
    return BigVGANFbank(BigVGANFbankConfig())
