"""Text frontend (``char`` backend) and the audio tokenizer's decode side.

Mirror of ``valle_tpu/data/tokenizer.py``. The text part is a host-side
copy (the JAX package's data modules reach ``jax``); only the ``char``
backend is ported, and ``espeak`` / ``pypinyin`` raise as they do in the
JAX package when their host libraries are missing. ``AudioTokenizer``
decodes codes to 24 kHz audio on the port's EnCodec decoder.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

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
    """EnCodec 24 kHz / 8 quantizers / 75 Hz, decode side.

    Without ``weights_path`` the codec weights are seeded random (tokens
    decode to structurally valid but not faithful audio). Loading real
    EnCodec weights and the encoder wait for later work.
    """

    def __init__(self, weights_path: Optional[str] = None,
                 bandwidth: float = 6.0, *, device="cuda",
                 seed: int = 0) -> None:
        from ..codec.model import EncodecConfig, EncodecModel

        if weights_path:
            raise NotImplementedError(
                "loading EnCodec weights is not ported yet")
        self.config = EncodecConfig()
        self.sample_rate = self.config.sample_rate
        self.channels = self.config.channels
        self.n_q = self.config.n_q_for_bandwidth(bandwidth)
        self.device = torch.device(device)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.codec = EncodecModel(self.config, generator=gen).eval()

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
