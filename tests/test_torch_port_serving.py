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
from torch_port_helpers import jax_audio_tokenizer
from torch_port_helpers import one_thread  # noqa: F401  (autouse)

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
    jtok = jax_audio_tokenizer()
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
        "import runpy, tempfile\n"
        "from pathlib import Path\n"
        "from valle_tpu_torch import native\n"
        "from valle_tpu_torch.codec.convert import import_encodec_state_dict\n"
        "from valle_tpu_torch.utils.symbol_table import SymbolTable\n"
        "codes = s.audio_tokenizer.encode(np.zeros((1, 700), np.float32))\n"
        "assert codes.shape == (1, 3, 8)\n"
        "d = Path(tempfile.mkdtemp())\n"
        "table = SymbolTable(eps=None)\n"
        "for i, c in enumerate(['<pad>', '<bos>', '<eos>']\n"
        "                      + list('abcdefghijklmnopqrstuvwxyz_')):\n"
        "    table.add(c, i)\n"
        "table.to_file(d / 'tokens.k2symbols')\n"
        "torch.save({'model': m.state_dict(), 'decoder_dim': 128,\n"
        "            'nhead': 4, 'num_decoder_layers': 1}, d / 'm.pt')\n"
        "native.write_wav(d / 'p.wav', np.zeros(3000, np.float32), 16000)\n"
        "sys.argv = ['infer', '--checkpoint', str(d / 'm.pt'),\n"
        "    '--text-tokens', str(d / 'tokens.k2symbols'),\n"
        "    '--text-extractor', 'char', '--audio-prompts', str(d / 'p.wav'),\n"
        "    '--text', 'hi', '--max-gen-len', '4', '--top-k', '1',\n"
        "    '--output-dir', str(d / 'out'), '--device', 'cpu']\n"
        "runpy.run_module('valle_tpu_torch.bin.infer', run_name='__main__')\n"
        "assert native.read_wav(d / 'out' / '0.wav')[0].shape[0] % 320 == 0\n"
        "sys.path.insert(0, 'tests')\n"
        "from torch_port_corpus import write_corpus\n"
        "from valle_tpu_torch.bin import trainer\n"
        "c = write_corpus(d / 'corpus', n_train=2, n_dev=1)\n"
        "stats = trainer.run(trainer.get_parser().parse_args([\n"
        "    '--device', 'cpu', '--manifest-dir', str(c), '--text-tokens',\n"
        "    str(c / 'unique_text_tokens.k2symbols'), '--exp-dir',\n"
        "    str(d / 'exp'), '--decoder-dim', '64', '--nhead', '4',\n"
        "    '--num-decoder-layers', '1', '--num-epochs', '1',\n"
        "    '--max-steps-per-epoch', '1', '--num-workers', '0',\n"
        "    '--oom-check', 'false', '--tensorboard', 'false']))\n"
        "assert stats.steps == 1 and (d / 'exp' / 'epoch-1.pt').exists()\n"
        "import json, threading, urllib.request\n"
        "from valle_tpu_torch.models import cb_decode\n"
        "from valle_tpu_torch.serving import ContinuousBatcher\n"
        "from valle_tpu_torch.bin import serve\n"
        "cb = ContinuousBatcher(m, s.text_tokenizer, s.text_collater,\n"
        "    s.audio_tokenizer, slots=2, text_pad=32, prompt_pad=8,\n"
        "    max_gen_len=4, chunk=2, top_k=1, compute_dtype=torch.float32,\n"
        "    device='cpu')\n"
        "r = cb.run([SynthesisRequest(text=w,\n"
        "    prompt_codes=np.zeros((4, 8), np.int32)) for w in 'abc'])\n"
        "assert [x.wav.shape for x in r] == [(x.frames * 320,) for x in r]\n"
        "fn, prep, info = serve.build_engine(serve.get_parser().parse_args([\n"
        "    '--checkpoint', str(d / 'm.pt'), '--text-tokens',\n"
        "    str(d / 'tokens.k2symbols'), '--text-backend', 'char',\n"
        "    '--mode', 'continuous', '--slots', '2', '--text-pad', '32',\n"
        "    '--max-gen-len', '4', '--device', 'cpu']))\n"
        "server, worker = serve.make_server(fn, port=0, info=info,\n"
        "                                   prepare_fn=prep)\n"
        "threading.Thread(target=server.serve_forever, daemon=True).start()\n"
        "req = urllib.request.Request(\n"
        "    f'http://127.0.0.1:{server.server_address[1]}/synthesize',\n"
        "    data=json.dumps({'text': 'hi', 'codes_only': True}).encode())\n"
        "with urllib.request.urlopen(req, timeout=120) as resp:\n"
        "    assert len(json.loads(resp.read())['codes'][0]) == 8\n"
        "server.shutdown(); worker.stop(); server.server_close()\n"
        "mf = VALLE(ValleConfig(d_model=128, nhead=4, num_layers=1,\n"
        "    num_quantizers=8, max_len=256, model_name='vallf',\n"
        "    add_prenet=True, norm_first=False),\n"
        "    generator=torch.Generator().manual_seed(0))\n"
        "sf = Synthesizer(mf, s.text_tokenizer, s.text_collater,\n"
        "    s.audio_tokenizer, top_k=1, compute_dtype=torch.float32,\n"
        "    device='cpu')\n"
        "rf = sf.synthesize([SynthesisRequest(text='hi',\n"
        "    prompt_codes=np.zeros((4, 8), np.int32))], max_gen_len=4)\n"
        "assert rf[0].wav.shape == (rf[0].frames * 320,)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'valle_tpu' or k.startswith('valle_tpu.')]\n"
        "assert not bad, bad[:5]\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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
    # the flash kernels take Dh 64 and 128: "auto" sends them no other
    for dh in (32, 96):
        assert resolve_nar_attn_impl("auto", 8, device="cuda",
                                     head_dim=dh) == "einsum"
    assert resolve_nar_attn_impl("auto", 8, device="cuda",
                                 head_dim=128) == "flash"
    assert resolve_nar_attn_impl("auto", 16, device="cuda",
                                 head_dim=128) == "einsum"
    assert resolve_nar_attn_impl("flash", 8, head_dim=128) == "flash"
    assert resolve_nar_score_bf16("auto", torch.bfloat16) is True
    assert resolve_nar_score_bf16("auto", torch.float32) is False
    reqs = _requests(SynthesisRequest) * 3
    assert plan_groups(reqs, 4) == jax_plan_groups(reqs, 4)
