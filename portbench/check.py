"""The comparison that decides ``correct`` in a serving cell.

After the window, a sample of the requests it finished, drawn from the
seed with the longest among them, is judged against the plain reference
(``reference/<model_name>.py`` and ``reference/encodec.py``), which
rebuilds every weight from the seed and encodes each prompt wav itself.
Four numbers are compared, each with a limit of its configuration:

- ``ar_gap``: over every served first-quantizer token, how far its logit
  lies below the best logit of the reference's AR forward, teacher-forced
  over the reference's prompt codes and the served tokens before it (the
  AR decode through the KV cache, judged at every step);
- ``nar_gap``: the same for the tokens of quantizers 1..Q-1 and the
  reference's NAR passes, each over the served quantizers below it;
- ``codec_err``: the RMS of the answered waveform's difference from the
  reference's decode of the served codes (clipped to [-1, 1], as a PCM16
  answer is), over the RMS of the latter;
- ``prompt_mismatch``: the share of the prompt codes that the program
  encoded which differ from the reference's encode of the same wav.

The served tokens are greedy, so a gap is 0 up to rounding. A control
(``control=True``) reads, at the same positions and from the same
inputs, the gap of the token that the reference put first when computed
one precision below the configuration's (``precision.below``: fp8 for a
bf16 ``dtype`` or ``codec_dtype``, TF32 for float32; the port's encoder
runs in float32), the decode error of that decoder and the mismatch of
that encoder.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import weights
from .reference import model_reference
from .reference.encodec import Codec
from .reference.precision import Precision, below, plain_matmuls
from .traffic import read_wav

NUMBERS = ("ar_gap", "nar_gap", "codec_err", "prompt_mismatch")


def text_ids(text: str, symbols: Sequence[str]) -> List[int]:
    """<bos>, one id a character (a space is the word separator "_"),
    <eos>; ids 0-2 are <pad>, <bos>, <eos>, then the sorted symbols."""
    index = {s: 3 + i for i, s in enumerate(sorted(symbols))}
    return [1] + [index["_" if c == " " else c] for c in text] + [2]


def pcm16_body(body: bytes) -> np.ndarray:
    """An answer's WAV body (44-byte header, PCM16) -> float32 samples as
    the server scaled them (k / 32767)."""
    return np.frombuffer(body[44:], "<i2").astype(np.float32) / 32767.0


def _gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The largest amount by which a token's logit lies below its row's
    best."""
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((ref_logits.max(dim=-1).values - got).max())


def _rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).norm() / ref.norm().clamp_min(1e-12))


@torch.no_grad()
def judge(cfg: Dict, seed: int, sample: List[Dict], device,
          control: bool = False) -> Dict[str, float]:
    """Readings of ``NUMBERS`` over ``sample``: dicts with ``text``,
    ``prompt_wav`` (a path), ``codes`` (F, Q) served, ``wav`` (the
    answer's samples) and ``prompt_codes`` (P, Q) as the program encoded
    them. With ``control``, also the control's readings, under
    ``control_<number>``."""
    model, codec = cfg["model"], cfg["codec"]
    n_q = model["num_quantizers"]
    sides = ("",) + (("control_",) if control else ())
    out = {side + k: 0.0 for side in sides for k in NUMBERS}
    mismatched = dict.fromkeys(sides, 0)
    total = 0
    Model = model_reference(model["model_name"]).Model
    with plain_matmuls():
        sd = {k: v.float() for k, v in weights.model_state(
            cfg, seed, device).items()}
        csd = weights.codec_state(cfg, seed, device)
        ref, rcodec = Model(model, sd), Codec(codec, csd)
        low = Model(model, sd, Precision(below(cfg["dtype"])))
        low_dec = Codec(codec, csd, Precision(below(cfg["codec_dtype"])))
        low_enc = Codec(codec, csd, Precision(below("float32")))
        for s in sample:
            wav = torch.as_tensor(read_wav(s["prompt_wav"]), device=device)
            pc = rcodec.encode(wav, n_q)
            text = torch.as_tensor(text_ids(s["text"], cfg["symbols"]),
                                   device=device)
            gen = torch.as_tensor(np.asarray(s["codes"]),
                                  device=device).long()
            want = rcodec.decode(gen).clamp(-1.0, 1.0)
            ar = ref.ar_logits(text, pc[:, 0], gen[:, 0])
            nar = [ref.nar_logits(text, pc, gen, i) for i in range(n_q - 1)]
            total += pc.shape[0] * n_q
            for side in sides:
                if side:
                    got_pc = low_enc.encode(wav, n_q)
                    ar_tok = low.ar_logits(text, pc[:, 0],
                                           gen[:, 0]).argmax(-1)
                    nar_tok = [low.nar_logits(text, pc, gen, i).argmax(-1)
                               for i in range(n_q - 1)]
                    got = low_dec.decode(gen).clamp(-1.0, 1.0)
                else:
                    got_pc = torch.as_tensor(np.asarray(s["prompt_codes"]),
                                             device=device).long()
                    ar_tok = gen[:, 0]
                    nar_tok = [gen[:, i + 1] for i in range(n_q - 1)]
                    got = torch.as_tensor(np.asarray(s["wav"]),
                                          device=device)
                if got_pc.shape != pc.shape:
                    mismatched[side] += pc.numel()
                else:
                    mismatched[side] += int((got_pc != pc).sum())
                out[side + "ar_gap"] = max(out[side + "ar_gap"],
                                           _gap(ar, ar_tok))
                for logits, tok in zip(nar, nar_tok):
                    out[side + "nar_gap"] = max(out[side + "nar_gap"],
                                                _gap(logits, tok))
                err = (_rel_rms(got, want) if got.shape == want.shape
                       else float("inf"))
                out[side + "codec_err"] = max(out[side + "codec_err"], err)
    for side in sides:
        out[side + "prompt_mismatch"] = mismatched[side] / max(total, 1)
    return out
