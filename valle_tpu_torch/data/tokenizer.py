"""Text frontend (``char`` backend) and the EnCodec audio tokenizer.

Mirror of ``valle_tpu/data/tokenizer.py``. The text part is a host-side
copy (the JAX package's data modules reach ``jax``); only the ``char``
backend is ported, and ``espeak`` / ``pypinyin`` raise as they do in the
JAX package when their host libraries are missing. ``AudioTokenizer``
encodes 24 kHz audio to codes and decodes codes to audio on the port's
EnCodec; ``tokenize_audio`` and ``AudioTokenExtractor`` read, mix down
and resample through the port's own audio library (``native``).
"""

from __future__ import annotations

import os
import re
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# phonemizer's Punctuation.default_marks()
DEFAULT_PUNCTUATION_MARKS = ';:,.!?¡¿—…"«»“”'


@dataclass(frozen=True)
class Separator:
    word: str = "_"
    syllable: str = "-"
    phone: str = "|"


class CharBackend:
    """Grapheme backend: words separated, characters as symbols."""

    def __init__(self, punctuation_marks: str = DEFAULT_PUNCTUATION_MARKS):
        self.punctuation_marks = punctuation_marks

    def phonemize(self, text: List[str], separator: Separator,
                  strip: bool = True, njobs: int = 1) -> List[str]:
        out = []
        for _text in text:
            _text = re.sub(" +", " ", _text.strip()).lower()
            pieces = [separator.phone.join(list(w)) for w in _text.split(" ")]
            out.append(separator.word.join(pieces))
        return out


class TextTokenizer:
    """Phonemize text into symbol lists (``char`` backend only)."""

    def __init__(self, language: str = "en-us", backend: str = "espeak",
                 separator: Separator = Separator(),
                 punctuation_marks: str = DEFAULT_PUNCTUATION_MARKS) -> None:
        if backend == "espeak":
            try:
                import phonemizer  # noqa: F401
            except ImportError as e:
                raise ImportError("espeak backend requires the 'phonemizer' "
                                  "package (espeak-ng)") from e
            raise NotImplementedError(
                "espeak backend is not ported yet; use backend='char'")
        if backend in ("pypinyin", "pypinyin_initials_finals"):
            try:
                import pypinyin  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "PypinyinBackend requires the 'pypinyin' package") from e
            raise NotImplementedError(
                "pypinyin backends are not ported yet; use backend='char'")
        if backend != "char":
            raise NotImplementedError(f"{backend}")
        self.backend = CharBackend(punctuation_marks=punctuation_marks)
        self.separator = separator

    def to_list(self, phonemized: str) -> List[str]:
        fields = []
        for word in phonemized.split(self.separator.word):
            pp = re.findall(r"\w+|[^\w\s]", word, re.UNICODE)
            fields.extend([p for p in pp if p != self.separator.phone]
                          + [self.separator.word])
        assert len("".join(fields[:-1])) == len(phonemized) - phonemized.count(
            self.separator.phone)
        return fields[:-1]

    def __call__(self, text, strip: bool = True) -> List[List[str]]:
        if isinstance(text, str):
            text = [text]
        phonemized = self.backend.phonemize(
            text, separator=self.separator, strip=strip, njobs=1)
        return [self.to_list(p) for p in phonemized]


def tokenize_text(tokenizer: TextTokenizer, text: str) -> List[str]:
    return tokenizer([text.strip()])[0]


class AudioTokenizer:
    """EnCodec 24 kHz / 8 quantizers / 75 Hz on ``device``.

    Weights load from ``weights_path`` (an ``encodec`` package state dict or
    checkpoint file) or the ``VALLE_TPU_ENCODEC_WEIGHTS`` environment
    variable, as in the JAX package; without them the codec weights are
    seeded random (codes and audio are structurally valid but not
    faithful) and ``pretrained`` is False.
    """

    def __init__(self, weights_path: Optional[str] = None,
                 bandwidth: float = 6.0, *, device="cuda",
                 seed: int = 0) -> None:
        from ..codec.convert import load_encodec_torch
        from ..codec.model import EncodecConfig, EncodecModel

        self.config = EncodecConfig()
        self.sample_rate = self.config.sample_rate
        self.channels = self.config.channels
        self.n_q = self.config.n_q_for_bandwidth(bandwidth)
        self.device = torch.device(device)
        weights_path = weights_path or os.environ.get(
            "VALLE_TPU_ENCODEC_WEIGHTS")
        if weights_path:
            self.codec = load_encodec_torch(weights_path, device=self.device)
            self.pretrained = True
        else:
            gen = torch.Generator(self.device).manual_seed(seed)
            self.codec = EncodecModel(self.config, generator=gen).eval()
            self.pretrained = False

    def encode(self, wav) -> np.ndarray:
        """wav: (B, T) or (B, T, 1) float32 -> codes (B, F, n_q) int32
        numpy, F = ceil(T / 320)."""
        from ..codec.model import encodec_encode

        wav = torch.as_tensor(np.asarray(wav, np.float32),
                              device=self.device)
        if wav.ndim == 2:
            wav = wav[..., None]
        return encodec_encode(self.codec, wav, n_q=self.n_q).cpu().numpy()

    def decode(self, codes, dtype: Optional[str] = None,
               transfer: str = "float32") -> np.ndarray:
        """codes: (B, F, n_q) -> wav (B, F*320) float32 numpy.

        ``dtype="bfloat16"`` runs the decoder in bf16. ``transfer="pcm16"``
        quantizes the waveform to int16 PCM on the device and copies 2
        bytes per sample to the host; it still returns float32 in [-1, 1].
        """
        from ..codec.model import encodec_decode

        if transfer not in ("float32", "pcm16"):
            raise ValueError(
                f"transfer must be 'float32'|'pcm16': {transfer!r}")
        codes = torch.as_tensor(codes, device=self.device)
        wav = encodec_decode(
            self.codec, codes,
            dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        if transfer == "pcm16":
            q = torch.clamp(torch.round(wav[..., 0] * 32767.0),
                            -32768.0, 32767.0).to(torch.int16)
            return q.cpu().numpy().astype(np.float32) / 32767.0
        return wav[..., 0].cpu().numpy()


def tokenize_audio(tokenizer: AudioTokenizer, audio_path: str) -> np.ndarray:
    """Load a wav, convert it to 24 kHz mono, EnCodec-encode it. Returns
    codes (1, F, n_q)."""
    from .. import native

    wav, sr = native.read_wav(audio_path)
    mono = native.convert_audio(wav, sr, tokenizer.sample_rate, 1)
    return tokenizer.encode(mono[None, :])


@dataclass
class AudioTokenConfig:
    frame_shift: float = 320.0 / 24000
    num_quantizers: int = 8

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "AudioTokenConfig":
        return AudioTokenConfig(**data)


def compute_num_frames(duration: float, frame_shift: float,
                       sampling_rate: int) -> int:
    """lhotse-compatible frame count (rounded sample-accurate)."""
    num_samples = round(duration * sampling_rate)
    window_hop = round(frame_shift * sampling_rate)
    return int((num_samples + window_hop // 2) // window_hop)


class AudioTokenExtractor:
    """Batch EnCodec code extraction: name "encodec"; features are
    (T, num_quantizers) int16 arrays trimmed to the lhotse-compatible
    frame count."""

    name = "encodec"
    config_type = AudioTokenConfig

    def __init__(self, config: Optional[AudioTokenConfig] = None,
                 weights_path: Optional[str] = None, *, device="cuda"):
        self.config = config or AudioTokenConfig()
        self.tokenizer = AudioTokenizer(weights_path=weights_path,
                                        device=device)

    @property
    def frame_shift(self) -> float:
        return self.config.frame_shift

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_quantizers

    def _frames(self, n: int) -> int:
        """The frame count of ``n`` samples at 24 kHz."""
        sr = self.tokenizer.sample_rate
        return compute_num_frames(round(n / sr, ndigits=12),
                                  self.frame_shift, sr)

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        from .. import native

        samples = np.asarray(samples, np.float32)
        if samples.ndim == 2:  # (channels, T) torchaudio-style
            samples = native.to_mono(samples.T)
        if sampling_rate != self.tokenizer.sample_rate:
            samples = native.resample(samples, sampling_rate,
                                      self.tokenizer.sample_rate)
        codes = self.tokenizer.encode(samples[None])  # (1, F, Q)
        expected = self._frames(samples.shape[-1])
        if abs(codes.shape[1] - expected) > 1:
            raise ValueError(f"{codes.shape[1]} frames, expected {expected}")
        return codes[0, :expected].astype(np.int16)

    def extract_batch(self, samples: List[np.ndarray],
                      sampling_rate: int) -> List[np.ndarray]:
        """Pad to a batch, encode once on the device, trim each."""
        from .. import native

        waves = []
        for w in samples:
            w = np.asarray(w, np.float32).reshape(-1)
            if sampling_rate != self.tokenizer.sample_rate:
                w = native.resample(w, sampling_rate,
                                    self.tokenizer.sample_rate)
            waves.append(w)
        batch = np.zeros((len(waves), max(len(w) for w in waves)),
                         np.float32)
        for i, w in enumerate(waves):
            batch[i, : len(w)] = w
        codes = self.tokenizer.encode(batch)  # (B, F, Q)
        return [codes[i, : self._frames(len(w))].astype(np.int16)
                for i, w in enumerate(waves)]
