"""The general generator of open-loop TTS traffic, read from a traffic
file (``traffic/<name>.json``) and a seed.

A run has three stretches: a lead-in that brings the server's queue to a
steady state (part of the set-up), the measured window, and a drain in
which arrivals go on until every request due in the window has been
taken up. The lead-in opens with one request of the shortest length,
which the server takes alone, and ``lead_in.burst`` requests due at once
``lead_in.burst_at_s`` later, while that request is being served, so
that the server drains the whole burst into one engine call as large as
a steady one; arrivals go on from then for up to ``lead_in.max_s``
seconds. The window starts at a fixed phase of the server's cycle, just
after the end of the engine call that took the burst's last request (no
burst: at the lead-in's start), and lead-in arrivals due after that are
not sent. Lead-in dues count from the lead-in's start, the others from
the window's.

Arrivals: ``arrivals.generator`` names how due times are drawn. The one
generator, ``poisson``, gives a stretch ``round(expected count)``
requests whose due times are sorted draws of the arrival intensity over
it (a Poisson process given its count): ``arrivals.rate_per_s`` on
average, shaped by an optional ``arrivals.profile`` of ``[seconds,
relative rate]`` pieces repeated from the stretch's zero (bursts, for
one), scaled so that its mean is the rate.

Lengths are the same stratified quantiles of the length distribution on
every seed, in a seeded order: a seed changes the order and the
arrivals, never the set of sizes.

A request's length is set through its text, since the server stops each
request at 16 x its text tokens (``frames_per_token``): a drawn duration
becomes a text of ``n`` characters (each a token, a space the word
separator), ``n + 2`` tokens with <bos> and <eos>, and ``frames =
min(16 (n + 2) + 1, max_gen_len)``. The first three letters of every
text spell its request index, so texts are distinct.
"""

from __future__ import annotations

import math
import statistics
import wave
from pathlib import Path
from typing import Dict, List

import numpy as np

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def text_tokens(frames_target: float, spec: Dict) -> int:
    """Tokens of text (with <bos>/<eos>) whose length rule gives the
    frame count nearest ``frames_target``, within the spec's bounds."""
    k = spec["frames_per_token"]
    n = round((frames_target - 1) / k)
    return int(min(max(n, spec["min_text_tokens"]), spec["max_text_tokens"]))


def frames_for(tokens: int, spec: Dict) -> int:
    """The frames the server answers for a text of ``tokens`` tokens."""
    return min(spec["frames_per_token"] * tokens + 1, spec["max_gen_len"])


def stratified_durations(n: int, spec: Dict) -> List[float]:
    """The n stratified quantiles (i + 1/2) / n of the clipped
    log-normal length distribution, in seconds."""
    dist = statistics.NormalDist(math.log(spec["median_s"]), spec["sigma"])
    out = []
    for i in range(n):
        d = math.exp(dist.inv_cdf((i + 0.5) / n))
        out.append(min(max(d, spec["min_s"]), spec["max_s"]))
    return out


def make_text(index: int, n_chars: int, rng: np.random.Generator) -> str:
    """``n_chars`` lowercase letters and single spaces (never first or
    last), starting with three letters that spell ``index``."""
    if n_chars < 3:
        raise ValueError(f"a text of {n_chars} characters cannot hold a "
                         "request index (min_text_tokens must be 5 or more)")
    code = "".join(LETTERS[(index // 26 ** p) % 26] for p in (2, 1, 0))
    out = list(code)
    while len(out) < n_chars:
        last = len(out) == n_chars - 1
        if not last and out[-1] != " " and rng.random() < 0.18:
            out.append(" ")
        else:
            out.append(LETTERS[int(rng.integers(26))])
    return "".join(out)


def _poisson(arrivals: Dict, rng: np.random.Generator, lo: float,
             hi: float) -> np.ndarray:
    """Sorted due times over [lo, hi): the expected count, each a draw of
    the intensity (flat, or shaped by ``profile``) over the stretch."""
    rate = arrivals["rate_per_s"]
    profile = arrivals.get("profile")
    if not profile:
        return np.sort(rng.uniform(lo, hi, round(rate * (hi - lo))))
    # cumulative intensity at the pieces' edges, over whole periods from
    # the stretch's zero
    secs = np.array([p[0] for p in profile], float)
    rel = np.array([p[1] for p in profile], float)
    period = secs.sum()
    rel = rel * period / float((secs * rel).sum())
    k0 = math.floor(lo / period)
    k1 = math.ceil(hi / period)
    edges, cum = [k0 * period], [0.0]
    for _ in range(k0, k1):
        for s, r in zip(secs, rel):
            edges.append(edges[-1] + s)
            cum.append(cum[-1] + rate * r * s)
    a, b = np.interp([lo, hi], edges, cum)
    draws = rng.uniform(a, b, round(b - a))
    return np.sort(np.interp(draws, cum, edges))


GENERATORS = {"poisson": _poisson}


def schedule(traffic: Dict, seed: int, seconds: float,
             rate: float = None) -> List[Dict]:
    """Every request of a run, in due order within each stretch: ``id``
    (its index), ``due`` (seconds from the lead-in's start for the
    lead-in, from the window's start otherwise), ``stretch`` ("lead_in",
    "window" or "drain"), ``text``, ``tokens``, ``frames`` and ``prompt``
    (an index into the prompt pool). With a burst, the lead-in's shortest
    request is id 0 and the burst ids 1 to ``lead_in.burst``. ``rate``
    replaces the traffic's ``arrivals.rate_per_s``."""
    arrivals = dict(traffic["arrivals"])
    if rate is not None:
        arrivals["rate_per_s"] = rate
    if arrivals["generator"] not in GENERATORS:
        raise ValueError(f"no arrival generator {arrivals['generator']!r} "
                         f"(have {sorted(GENERATORS)})")
    draw = GENERATORS[arrivals["generator"]]
    spec, lead = traffic["lengths"], traffic["lead_in"]
    rng = _rng(seed, 3)
    parts = []
    if lead["burst"]:
        at = lead["burst_at_s"]
        parts = [("lead_in", np.zeros(1)),
                 ("lead_in", np.full(lead["burst"], at)),
                 ("lead_in", draw(arrivals, rng, at, lead["max_s"]))]
    parts += [("window", draw(arrivals, rng, 0.0, float(seconds))),
              ("drain", draw(arrivals, rng, float(seconds),
                             float(seconds) + traffic["drain_s"]))]
    reqs = []
    for k, (name, dues) in enumerate(parts):
        n = len(dues)
        # the lead-in's first request is the shortest
        durs = (stratified_durations(n, spec) if k or not lead["burst"]
                else [spec["min_s"]])
        order = rng.permutation(n)
        for due, i in zip(dues, order):
            tokens = text_tokens(durs[i] * spec["frame_rate"], spec)
            reqs.append(dict(id=len(reqs), due=float(due), stretch=name,
                             tokens=tokens, frames=frames_for(tokens, spec),
                             prompt=int(rng.integers(
                                 traffic["prompts"]["pool"]))))
    text_rng = _rng(seed, 4)
    for r in reqs:
        r["text"] = make_text(r["id"], r["tokens"] - 2, text_rng)
    return reqs


def check_sample(reqs: List[Dict], seed: int, n: int) -> List[int]:
    """The ids whose answers the reference checks: the longest request
    due in the window (the first of the longest) and ``n - 1`` others
    drawn from the seed."""
    window = [r for r in reqs if r["stretch"] == "window"]
    longest = max(window, key=lambda r: (r["frames"], -r["id"]))
    rest = [r["id"] for r in window if r["id"] != longest["id"]]
    picked = _rng(seed, 5).choice(len(rest), min(n - 1, len(rest)),
                                  replace=False)
    return [longest["id"]] + sorted(rest[i] for i in picked)


def prompt_waves(traffic: Dict, seed: int) -> List[np.ndarray]:
    """The pool of prompt waveforms, float32 in [-1, 1]: a voiced tone
    (a random pitch and five harmonics) under a syllable-rate envelope,
    plus noise, peak 0.5."""
    spec = traffic["prompts"]
    sr, n = spec["sample_rate"], round(spec["seconds"] * spec["sample_rate"])
    rng = _rng(seed, 6)
    t = np.arange(n) / sr
    out = []
    for _ in range(spec["pool"]):
        f0 = rng.uniform(90.0, 250.0)
        voice = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3))
                    / h for h in range(1, 6))
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t)
        w = voice * env + 0.05 * rng.standard_normal(n)
        out.append((0.5 * w / np.abs(w).max()).astype(np.float32))
    return out


def write_wav(path: Path, wav: np.ndarray, sample_rate: int) -> None:
    """Mono PCM16."""
    pcm = np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def read_wav(path: Path) -> np.ndarray:
    """Mono PCM16 -> float32 (divided by 32768, as readers do)."""
    with wave.open(str(path), "rb") as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    return pcm.astype(np.float32) / 32768.0
