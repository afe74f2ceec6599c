"""The traffic generator: the same seed gives the same requests, every
seed the same sizes, and the server's length rule gives each request
the frames that were drawn."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic as gen

BENCH = Path(__file__).resolve().parents[1]
TRAFFIC = json.loads((BENCH / "traffic" / "serve.poisson.json").read_text())


def test_schedule_is_deterministic_per_seed():
    a = gen.schedule(TRAFFIC, 2 ** 31 + 11, 51)
    b = gen.schedule(TRAFFIC, 2 ** 31 + 11, 51)
    c = gen.schedule(TRAFFIC, 2 ** 31 + 12, 51)
    assert a == b
    assert [r["due"] for r in a] != [r["due"] for r in c]
    assert [r["text"] for r in a] != [r["text"] for r in c]


def test_every_seed_gets_the_same_sizes():
    for stretch in ("lead_in", "window", "drain"):
        sizes = [sorted(r["frames"] for r in gen.schedule(TRAFFIC, s, 51)
                        if r["stretch"] == stretch) for s in (1, 2, 99)]
        assert sizes[0] == sizes[1] == sizes[2]
    window = [r for r in gen.schedule(TRAFFIC, 5, 51)
              if r["stretch"] == "window"]
    assert len(window) == round(TRAFFIC["arrivals"]["rate_per_s"] * 51)
    assert all(0.0 <= r["due"] < 51 for r in window)


def test_lead_in_opens_with_the_shortest_then_a_burst():
    reqs = gen.schedule(TRAFFIC, 2 ** 31 + 3, 51)
    lead = [r for r in reqs if r["stretch"] == "lead_in"]
    n, at = TRAFFIC["lead_in"]["burst"], TRAFFIC["lead_in"]["burst_at_s"]
    assert lead[0]["due"] == 0.0 and lead[0]["frames"] == 81
    assert [r["due"] for r in lead[1: 1 + n]] == [at] * n
    assert max(r["frames"] for r in lead[1: 1 + n]) == 1024
    assert all(at < r["due"] < TRAFFIC["lead_in"]["max_s"]
               for r in lead[1 + n:])
    assert [r["id"] for r in reqs] == list(range(len(reqs)))


def test_no_lead_in():
    t = dict(TRAFFIC, lead_in=dict(burst=0, burst_at_s=0.0, max_s=0.0))
    reqs = gen.schedule(t, 7, 0.1, rate=960.0)
    assert len(reqs) == round(960.0 * (0.1 + TRAFFIC["drain_s"]))
    assert sum(r["stretch"] == "window" for r in reqs) == 96


def test_the_generator_is_named_by_the_traffic():
    t = dict(TRAFFIC, arrivals=dict(TRAFFIC["arrivals"], generator="nope"))
    with pytest.raises(ValueError):
        gen.schedule(t, 1, 51)


def test_a_flat_profile_is_plain_poisson():
    flat = dict(TRAFFIC, arrivals=dict(TRAFFIC["arrivals"],
                                       profile=[[7.0, 2.0]]))
    a = gen.schedule(TRAFFIC, 2 ** 31 + 9, 51)
    b = gen.schedule(flat, 2 ** 31 + 9, 51)
    assert [r["frames"] for r in a] == [r["frames"] for r in b]
    assert np.allclose([r["due"] for r in a], [r["due"] for r in b])


def test_bursts_keep_the_mean_rate():
    """5 s at 3x the rate of the other 15 s of every 20 s."""
    rate = 4.0
    bursty = dict(TRAFFIC, arrivals=dict(generator="poisson",
                                         rate_per_s=rate,
                                         profile=[[5.0, 3.0], [15.0, 1.0]]))
    reqs = gen.schedule(bursty, 2 ** 31 + 21, 200.0)
    window = np.array([r["due"] for r in reqs if r["stretch"] == "window"])
    assert len(window) == round(rate * 200.0)
    in_burst = (window % 20.0) < 5.0
    # 5 s at 2x the mean, 15 s at 2/3 of it: half the arrivals each side
    assert abs(in_burst.mean() - 0.5) < 0.06


def test_lengths_follow_the_distribution():
    spec = TRAFFIC["lengths"]
    durs = gen.stratified_durations(1000, spec)
    assert min(durs) >= spec["min_s"] and max(durs) <= spec["max_s"]
    assert abs(np.median(durs) - spec["median_s"]) < 0.05
    frames = [gen.frames_for(gen.text_tokens(d * 75, spec), spec)
              for d in durs]
    assert min(frames) == 81 and max(frames) == spec["max_gen_len"]


def test_texts_are_distinct_and_one_token_a_character():
    reqs = gen.schedule(TRAFFIC, 3, 51)
    texts = [r["text"] for r in reqs]
    assert len(set(texts)) == len(texts)
    for t in texts:
        assert t == t.strip() and "  " not in t
        assert set(t) <= set(gen.LETTERS + " ")


def test_length_rule_through_the_port_tokenizer():
    """16 x the text's tokens (with <bos>/<eos>), as the port counts
    them, plus one, gives the frames drawn."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import TextTokenizer, tokenize_text

    tok = TextTokenizer(backend="char")
    cfg = json.loads((BENCH / "configs" / "valle.json").read_text())
    coll = TextTokenCollater(cfg["symbols"])
    for r in gen.schedule(TRAFFIC, 8, 51)[:200]:
        _, lens = coll.index([tokenize_text(tok, r["text"])])
        assert int(lens[0]) == r["tokens"]
        assert r["frames"] == min(16 * int(lens[0]) + 1, 1024)


def test_check_sample_holds_the_longest():
    reqs = gen.schedule(TRAFFIC, 4, 51)
    ids = gen.check_sample(reqs, 4, 12)
    window = [r for r in reqs if r["stretch"] == "window"]
    assert len(ids) == len(set(ids)) == 12
    assert reqs[ids[0]]["frames"] == max(r["frames"] for r in window)
    assert ids == gen.check_sample(reqs, 4, 12)


def test_prompt_pool_and_wav_round_trip(tmp_path):
    waves = gen.prompt_waves(TRAFFIC, 9)
    assert len(waves) == TRAFFIC["prompts"]["pool"]
    assert all(w.shape == (72000,) and np.abs(w).max() <= 0.5 + 1e-6
               for w in waves)
    path = tmp_path / "p.wav"
    gen.write_wav(path, waves[0], 24000)
    back = gen.read_wav(path)
    assert np.abs(back - waves[0]).max() < 1e-4


def test_make_text_refuses_texts_too_short_for_an_index():
    with pytest.raises(ValueError):
        gen.make_text(0, 2, np.random.default_rng(0))
