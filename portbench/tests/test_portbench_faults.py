"""A whole run of the serving driver on the CPU at a tiny size, with the
check for a card skipped: a sound run is correct, and each fault that a
serving cell can have, planted in the timed path, makes it incorrect:
a token altered where it is produced, a decode step that leaves its
state (the KV cache) unchanged, an answer altered where it is produced.
The control, the reference one precision lower in the program's place,
comes out incorrect too."""

import copy
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import check
from portbench.drivers import open_loop_http as driver
from portbench.run import verdict

BENCH = Path(__file__).resolve().parents[1]
TINY = json.loads((BENCH / "tests" / "tiny.json").read_text())
TRAFFIC = json.loads((BENCH / "tests" / "tiny_traffic.json").read_text())
SEED = 2 ** 31 + 77


def _run():
    torch.set_num_threads(2)
    return driver.run({"name": "tiny", "chips": 1}, TINY, TRAFFIC, SEED, 3.0,
                      False, torch.device("cpu"), time.monotonic())


def _correct(out):
    return verdict(out["readings"], TINY, TRAFFIC)[0]


def test_sound_run_is_correct():
    out = _run()
    assert out["failed"] == 0 and out["attempted"] == 9
    assert out["readings"]["checked"] == 3
    assert out["readings"]["frames"] == 0
    assert _correct(out), out["readings"]
    # the lead-in: its short first request alone, then the whole burst in
    # one call, which ends just before the window starts
    lead = [c for c in out["calls"] if c[1] < 0]
    assert [c[2] for c in lead][0] == 1 and len(lead) == 2
    assert lead[1][2] >= TRAFFIC["lead_in"]["burst"]
    assert lead[1][1] == pytest.approx(-driver.ANCHOR_S, abs=1e-3)


def test_a_mode_the_driver_does_not_serve_is_refused():
    cb = dict(TRAFFIC, server=dict(TRAFFIC["server"], mode="continuous"))
    with pytest.raises(ValueError, match="static"):
        driver.run({"name": "tiny", "chips": 1}, TINY, cb, SEED, 3.0,
                   False, torch.device("cpu"), time.monotonic())


def test_altered_token_is_caught(monkeypatch):
    from valle_tpu_torch.models import inference

    orig = inference.ar_stop_step

    def altered(*a, **kw):
        tok, done, lens = orig(*a, **kw)
        return torch.where(done, tok, (tok + 1) % 1024), done, lens

    monkeypatch.setattr(inference, "ar_stop_step", altered)
    out = _run()
    assert not _correct(out)
    assert out["readings"]["ar_gap"] > TINY["limits"]["ar_gap"]


def test_unchanged_cache_is_caught(monkeypatch):
    from valle_tpu_torch.models import inference

    orig = inference.encoder_stack_decode_step

    def stale(stack, x, cache, *a, **kw):
        return orig(stack, x, copy.deepcopy(cache), *a, **kw)

    monkeypatch.setattr(inference, "encoder_stack_decode_step", stale)
    out = _run()
    assert not _correct(out)


def test_altered_answer_is_caught(monkeypatch):
    from valle_tpu_torch.data.tokenizer import AudioTokenizer

    orig = AudioTokenizer.decode

    def louder(self, codes, **kw):
        return orig(self, codes, **kw) * 0.9

    monkeypatch.setattr(AudioTokenizer, "decode", louder)
    out = _run()
    assert not _correct(out)
    assert out["readings"]["codec_err"] > TINY["limits"]["codec_err"]


def test_control_is_incorrect(monkeypatch):
    """The control's readings (fp8 model and decoder, TF32 encoder) at the
    same positions fail at least one limit."""
    seen = {}
    orig = check.judge

    def with_control(cfg, seed, sample, device, control=False):
        seen.update(orig(cfg, seed, sample, device, control=True))
        return orig(cfg, seed, sample, device)

    monkeypatch.setattr(check, "judge", with_control)
    _run()
    ctl = {k[len("control_"):]: v for k, v in seen.items()
           if k.startswith("control_")}
    ctl.update(frames=0.0, checked=3, expected=3)
    assert not verdict(ctl, TINY, TRAFFIC)[0], ctl
