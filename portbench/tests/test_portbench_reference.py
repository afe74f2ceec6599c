"""The plain reference against the port on the CPU, and what the
harness imports: the chip path loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``valle_tpu`` (compared whole, so
``valle_tpu_torch`` passes), and the reference loads nothing of the
port."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from portbench import weights
from portbench.check import text_ids
from portbench.reference.encodec import Codec
from portbench.reference.encodec import parameter_shapes as codec_shapes
from portbench.reference.precision import to_fp8, to_tf32
from portbench.reference.valle import Model, parameter_shapes

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = json.loads((BENCH / "tests" / "tiny.json").read_text())


def _top_level_names(code: str):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], capture_output=True, text=True,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_chip_path_loads_no_jax():
    names = _top_level_names(
        "import portbench.run, portbench.loadgen, portbench.tools.probe\n"
        "import portbench.drivers.open_loop_http as d\n"
        "import portbench.tools.readings\n"
        "from valle_tpu_torch.bin.serve import make_server\n"
        "from valle_tpu_torch.models import inference\n"
        "from valle_tpu_torch.serving import Synthesizer\n"
        "from valle_tpu_torch.data.tokenizer import AudioTokenizer\n"
        "from portbench.run import read_metric, BENCH\n"
        "for p in sorted((BENCH / 'metrics').glob('*.py')):\n"
        "    if not p.stem.startswith('_'):\n"
        "        read_metric(p.stem, {'trace': None, 'calls': [],\n"
        "                    'window': (0, 1), 'requests': [],\n"
        "                    'cfg': {'codec': {'frame_rate': 75}}})\n")
    assert "valle_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "valle_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _top_level_names(
        "import portbench.reference.valle, portbench.reference.encodec\n"
        "import portbench.check, portbench.weights, portbench.traffic\n"
        "from portbench.reference import model_reference\n"
        "model_reference('valle')\n")
    assert not names & {"valle_tpu_torch", "valle_tpu", "jax"}


def test_parameter_names_are_the_port_state_dict():
    from valle_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    with torch.device("meta"):
        model = VALLE(ValleConfig(**TINY["model"]))
        codec = EncodecModel(EncodecConfig())
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sd == parameter_shapes(TINY["model"])
    csd = {k: tuple(v.shape) for k, v in codec.state_dict().items()}
    assert csd == codec_shapes(TINY["codec"])


def test_weights_are_seeded_and_tied():
    a = weights.model_state(TINY, 2 ** 31 + 5, "cpu")
    b = weights.model_state(TINY, 2 ** 31 + 5, "cpu")
    c = weights.model_state(TINY, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ar_predict_layer.weight"],
                           c["ar_predict_layer.weight"])
    assert a["nar_predict_layers.0.weight"] is a[
        "nar_audio_embeddings.2.word_embeddings.weight"]
    assert all(v.dtype == torch.bfloat16 for v in a.values())


def _port_model(seed):
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    model = VALLE(ValleConfig(**TINY["model"]))
    model.load_state_dict(weights.model_state(TINY, seed, "cpu"))
    return model.float().eval()


def test_port_fp32_greedy_tokens_are_the_reference_argmax():
    """The port's fp32 exact decode and NAR passes, teacher-forced
    through the reference: every served token is the reference's best
    to rounding, and the EOS logit never wins."""
    from valle_tpu_torch.models.inference import valle_inference

    torch.manual_seed(0)
    model = _port_model(3)
    text = "abc de"
    ids = torch.tensor([text_ids(text, TINY["symbols"])])
    prompt = torch.randint(0, 1024, (1, 40, 8))
    codes, lens = valle_inference(
        model, ids, torch.tensor([ids.shape[1]]), prompt, torch.tensor([40]),
        top_k=1, max_gen_len=200, compute_dtype=torch.float32)
    n = int(lens[0])
    assert n == 16 * ids.shape[1] + 1
    sd = {k: v.float() for k, v in weights.model_state(TINY, 3,
                                                       "cpu").items()}
    ref = Model(TINY["model"], sd)
    gen = codes[0, :n].long()
    ar = ref.ar_logits(ids[0], prompt[0, :, 0], gen[:, 0])
    assert (ar.max(-1).values - ar.gather(-1, gen[:, :1])[:, 0]).max() < 1e-3
    assert (ar[:, 1024] < ar.max(-1).values - 30).all()
    for stage in range(7):
        nar = ref.nar_logits(ids[0], prompt[0], gen, stage)
        gap = nar.max(-1).values - nar.gather(
            -1, gen[:, stage + 1: stage + 2])[:, 0]
        assert gap.max() < 1e-3


def test_reference_codec_is_the_port_codec():
    from valle_tpu_torch.codec.model import (EncodecConfig, EncodecModel,
                                             encodec_decode, encodec_encode)

    sd = weights.codec_state(TINY, 4, "cpu")
    port = EncodecModel(EncodecConfig())
    port.load_state_dict(sd)
    ref = Codec(TINY["codec"], sd)
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 1024, (1, 40, 8), generator=g)
    want = ref.decode(codes[0])
    got = encodec_decode(port, codes)[0, :, 0]
    assert float((got - want).norm() / want.norm()) < 1e-5
    assert want.abs().max() < 1.0          # final_gain keeps it in range
    wav = 0.3 * torch.sin(torch.arange(24000) * 0.05)
    assert torch.equal(encodec_encode(port, wav[None, :, None])[0].long(),
                       ref.encode(wav, 8))


def test_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0e-3])
    t = to_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2 ** -9
    assert np.isclose(float(t[2]), 3.0e-3, rtol=2 ** -10)
    y = torch.randn(4, 64)
    err = ((to_fp8(y) - y).abs() / y.abs().amax(-1, keepdim=True)).max()
    assert 0 < err < 2 ** -4
