"""Port serving and port-only contracts: Synthesizer vs the JAX
Synthesizer, the alpha-carrying decode step, no JAX at run time, and the
decode mode a Synthesizer batch resolves to."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from valle_tpu.data import AudioTokenizer as JaxAudioTokenizer
from valle_tpu.data import TextTokenizer as JaxTextTokenizer
from valle_tpu.data.collation import TextTokenCollater as JaxCollater
from valle_tpu.models import ValleModel
from valle_tpu.serving import SynthesisRequest as JaxRequest
from valle_tpu.serving import Synthesizer as JaxSynthesizer
from valle_tpu.serving import plan_groups as jax_plan_groups
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models.inference import _frontends, valle_ar_decode
from valle_tpu_torch.modules.transformer import encoder_stack_apply
from valle_tpu_torch.ops import masks as M
from valle_tpu_torch.serving import (SynthesisRequest, Synthesizer,
                                     plan_groups, resolve_nar_attn_impl,
                                     resolve_nar_score_bf16)
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict)

from torch_port_helpers import make_pair, slice_inputs, t

REPO = Path(__file__).resolve().parents[1]
SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(text="hello world",
                prompt_codes=rng.randint(0, 1024, (6, 8))),
            cls(text="a longer different sentence here",
                prompt_text="prompt words",
                prompt_codes=rng.randint(0, 1024, (4, 8))),
            cls(text="short")]


def test_synthesizer_matches_jax_synthesizer():
    jcfg, params, model = make_pair(prefix_mode=2)
    jtok = JaxAudioTokenizer()
    jsynth = JaxSynthesizer(
        ValleModel(jcfg), params, JaxTextTokenizer(backend="char"),
        JaxCollater(SYMBOLS), jtok, top_k=1, max_gen_len=32,
        compute_dtype=jnp.float32, codec_dtype="float32")
    tok = AudioTokenizer(device="cpu")
    load_numpy_state_dict(tok.codec, encodec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtok.params)))
    synth = Synthesizer(model, TextTokenizer(backend="char"),
                        TextTokenCollater(SYMBOLS), tok, top_k=1,
                        max_gen_len=32, compute_dtype=torch.float32,
                        codec_dtype="float32", device="cpu")
    ref = jsynth.synthesize(_requests(JaxRequest), max_gen_len=16)
    out = synth.synthesize(_requests(SynthesisRequest), max_gen_len=16)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.frames == b.frames
        assert np.array_equal(a.codes, b.codes)
        assert a.wav.shape == (a.frames * 320,)
        np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=1e-4)


def test_cached_decode_equals_full_forward_with_alpha():
    """alpha != 1: the cached decode step applies alpha like the prefill,
    so greedy tokens equal the argmax of a full-sequence forward over the
    teacher-forced sequence at every step (the reference's semantics)."""
    _, _, model = make_pair(seed=1)
    with torch.no_grad():
        model.ar_audio_position.alpha.fill_(0.7)
        model.ar_text_position.alpha.fill_(0.8)
    x = slice_inputs(seed=2)
    B, S = x["text"].shape
    P, N = x["prompt_codes"].shape[1], 12
    text, tl = t(x["text"]), t(np.array([16, 16]))
    prompt, pl = t(x["prompt_codes"][..., 0]), t(np.array([P, P]))
    codes, lens = valle_ar_decode(model, text, tl, prompt, pl, top_k=1,
                                  max_gen_len=N, force_full_length=True)
    assert (lens == N).all()
    seq = torch.cat([prompt, codes[:, : N - 1].long()], dim=1)
    with torch.no_grad():
        xe, ye = _frontends(model, text.long(), seq, torch.float32)
        bias = M.ar_xy_attn_bias(tl, pl + N - 1, S, P + N - 1)
        hid = encoder_stack_apply(model.ar_decoder, torch.cat([xe, ye], 1),
                                  bias)
        logits = hid[:, S + P - 1:] @ model.ar_predict_layer.weight.T
    assert torch.equal(logits.argmax(-1).to(torch.int32), codes)


def test_port_runs_without_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from valle_tpu_torch.models.valle import VALLE, ValleConfig\n"
        "from valle_tpu_torch.data.collation import TextTokenCollater\n"
        "from valle_tpu_torch.data.tokenizer import (AudioTokenizer,\n"
        "    TextTokenizer)\n"
        "from valle_tpu_torch.serving import SynthesisRequest, Synthesizer\n"
        "cfg = ValleConfig(d_model=128, nhead=4, num_layers=1,\n"
        "                  num_quantizers=8, max_len=256)\n"
        "m = VALLE(cfg, generator=torch.Generator().manual_seed(0))\n"
        "s = Synthesizer(m, TextTokenizer(backend='char'),\n"
        "    TextTokenCollater(list('abcdefghijklmnopqrstuvwxyz_')),\n"
        "    AudioTokenizer(device='cpu'), top_k=1, decode_mode='fused',\n"
        "    compute_dtype=torch.float32, nar_attn_impl='flash',\n"
        "    device='cpu')\n"
        "r = s.synthesize([SynthesisRequest(text='hi there',\n"
        "    prompt_codes=np.zeros((4, 8), np.int32))], max_gen_len=4)\n"
        "assert r[0].wav.shape == (r[0].frames * 320,)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'valle_tpu' or k.startswith('valle_tpu.')]\n"
        "assert not bad, bad[:5]\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout


def test_synthesizer_auto_resolves_per_batch():
    """decode_mode "auto" resolves from each padded batch: int8 for 8
    requests on a cache of at least 640 rows, fused_w8 for 3 (padded to
    4); ``last_decode_mode`` shows the mode that ran."""
    _, _, model = make_pair()
    synth = Synthesizer(model, TextTokenizer(backend="char"),
                        TextTokenCollater(SYMBOLS),
                        AudioTokenizer(device="cpu"), top_k=1,
                        decode_mode="auto",
                        compute_dtype=torch.float32, codec_dtype="float32",
                        device="cpu")
    rng = np.random.RandomState(1)
    reqs = [SynthesisRequest(text=f"request {w} " * 14,
                             prompt_codes=rng.randint(0, 1024, (450, 8)))
            for w in "abcdefgh"]
    out = synth.synthesize(reqs, max_gen_len=24)     # cache 144+480+24+2
    assert synth.last_decode_mode == "int8"
    assert len(out) == 8 and all(r.frames > 0 for r in out)
    out = synth.synthesize(_requests(SynthesisRequest), max_gen_len=8)
    assert synth.last_decode_mode == "fused_w8"
    assert [r.codes.shape for r in out] == [(r.frames, 8) for r in out]


def test_resolvers_and_plan_groups():
    assert resolve_nar_attn_impl("auto", 8, device="cpu",
                                 head_dim=64) == "einsum"
    assert resolve_nar_attn_impl("auto", 8, device="cuda",
                                 head_dim=64) == "flash"
    assert resolve_nar_attn_impl("auto", 16, device="cuda",
                                 head_dim=64) == "einsum"
    assert resolve_nar_attn_impl("flash", 64, head_dim=64) == "flash"
    # the flash kernels take Dh 64 only: "auto" never sends them another
    for dh in (32, 96, 128):
        assert resolve_nar_attn_impl("auto", 8, device="cuda",
                                     head_dim=dh) == "einsum"
    assert resolve_nar_attn_impl("flash", 8, head_dim=128) == "flash"
    assert resolve_nar_score_bf16("auto", torch.bfloat16) is True
    assert resolve_nar_score_bf16("auto", torch.float32) is False
    reqs = _requests(SynthesisRequest) * 3
    assert plan_groups(reqs, 4) == jax_plan_groups(reqs, 4)
