"""Tensor parallelism in the port (``parallel/tensor.py``, the 'model'
axis of ``parallel.mesh.make_mesh``) against the JAX package's on the
CPU, small (d 64, 4 heads, 2 layers, fp32, one intra-op thread):

- the split rule: every leaf's split dimension equals JAX's
  ``param_shardings`` spec carried through the layout flip (the JAX
  leaves are filled with their index along the 'model' axis and carried
  over by ``utils/convert.py``), for VALL-E with prenets, VALL-F and the
  Transformer TTS, and a guard case (d 66 at tp 4: the out-projections
  stay whole, the FFNs split);
- serving: greedy "exact" and "unroll" codes of
  ``Synthesizer(mesh=make_mesh(dp=1, tp=2, devices=["cpu", "cpu"]))``
  equal JAX's Synthesizer on a dp1 x tp2 mesh and the port's mesh=None,
  bit for bit; and on a dp2 x tp2 mesh of four CPU shards;
- training in one process with two shard threads: a ScaledAdam step of
  the tp=2 shards equals the whole model's step (loss 1e-5, grad norm
  1e-4, parameters rtol 3e-5) with dropout off and on (the FFN's mask is
  the slice of the whole one); the optimizer's buffers gather whole and
  cut back to the same shards;
- the refusals JAX makes: the kernel decode modes and the
  ContinuousBatcher under tp > 1, a device count tp does not divide.

The trainer's ``--tp 2`` over two gloo ranks, against one process and
against JAX's dp x tp2 ``make_train_step``, is in
``test_torch_port_distributed.py``."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.data import TextTokenizer as JaxTextTokenizer
from valle_tpu.data.collation import TextTokenCollater as JaxCollater
from valle_tpu.models import ValleConfig as JaxValleConfig
from valle_tpu.models import ValleModel, init_valle
from valle_tpu.models import transformer as jtr
from valle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from valle_tpu.parallel.mesh import param_shardings
from valle_tpu.serving import SynthesisRequest as JaxRequest
from valle_tpu.serving import Synthesizer as JaxSynthesizer
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models.transformer import (TransformerTtsConfig,
                                                TransformerTtsModel)
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.parallel.mesh import make_mesh
from valle_tpu_torch.parallel.tensor import (ModelShard, ThreadGroup,
                                             gather_optimizer_state,
                                             gather_state_dict, param_specs,
                                             shard_optimizer_state,
                                             sharded_copies)
from valle_tpu_torch.serving import (ContinuousBatcher, SynthesisRequest,
                                     Synthesizer)
from valle_tpu_torch.training import (TrainState, make_optimizer,
                                      make_train_step)
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict,
                                           transformer_tts_state_dict_from_jax,
                                           valle_state_dict_from_jax)

from torch_port_dp_worker import no_dropout_seeds
from torch_port_helpers import TRAIN_PINS, TRAIN_SMALL, make_pair
from torch_port_helpers import jax_audio_tokenizer
from torch_port_helpers import train_batch

SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
TEXTS = ("hello there", "one more", "third request text", "tiny")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the split rule
# ---------------------------------------------------------------------------

def _encoded(params, tp):
    """JAX's params with every leaf replaced by its index (+1) along the
    axis ``param_shardings`` puts on 'model' (zeros for a whole leaf)."""
    mesh = jax_make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])

    def enc(leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(
            sharding.spec))
        out = np.zeros(leaf.shape, np.float32)
        for ax, s in enumerate(spec):
            if s == "model":
                shape = [1] * leaf.ndim
                shape[ax] = -1
                out = out + (np.arange(leaf.shape[ax]) + 1.0).reshape(shape)
        return out

    return jax.tree_util.tree_map(enc, params,
                                  param_shardings(params, mesh))


def _shapes(init, jcfg):
    """The shapes of JAX's parameter tree (traced, never run)."""
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))[0]


def _split_dim(v):
    """The one dimension along which a carried-over index varies (None:
    constant, as the entries the converter writes itself)."""
    v = np.asarray(v)
    dims = [d for d in range(v.ndim) if v.shape[d] > 1
            and np.any(np.diff(v, axis=d) != 0)]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


SPEC_CASES = {
    "valle_prenet": ("valle", dict(add_prenet=True), 2),
    "vallf": ("valle", dict(model_name="vallf"), 2),
    "tts": ("tts", dict(), 2),
    "tts_scaling": ("tts", dict(scaling_xformers=True), 2),
    "tts_prenet": ("tts", dict(add_prenet=True), 2),
    # 66 % 4 != 0: the out-projections stay whole; 264 % 4 == 0: FFNs split
    "guard": ("valle", dict(d_model=66, nhead=6, add_prenet=True), 4),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_split_rule_matches_jax_param_shardings(case):
    kind, kw, tp = SPEC_CASES[case]
    if kind == "valle":
        kw = {**TRAIN_SMALL, **kw}
        jcfg = JaxValleConfig(**kw)
        params = _shapes(init_valle, jcfg)
        carried = valle_state_dict_from_jax(_encoded(params, tp), jcfg)
        model = VALLE(ValleConfig(**kw))
    else:
        kw = dict(d_model=64, nhead=4, num_layers=2, num_mel_bins=12,
                  max_len=256, **kw)
        jcfg = jtr.TransformerTtsConfig(**kw)
        params = _shapes(jtr.init_transformer_tts, jcfg)
        carried = transformer_tts_state_dict_from_jax(
            _encoded(params, tp), jcfg)
        model = TransformerTtsModel(TransformerTtsConfig(**kw))
    mine = param_specs(model.state_dict(), tp)
    assert mine.keys() == carried.keys()
    want = {k: _split_dim(v) for k, v in carried.items()}
    assert mine == want
    split = {k for k, d in mine.items() if d is not None}
    assert split and len(split) < len(mine)
    if case == "guard":
        assert not any("out_proj" in k for k in split)
        assert any("linear1" in k for k in split)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cls, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(text=t, prompt_codes=rng.randint(0, 1024, (5, 8)))
            for t in TEXTS[:n]]


def _port_synth(model, tok, **kw):
    return Synthesizer(model, TextTokenizer(backend="char"),
                       TextTokenCollater(SYMBOLS), tok,
                       compute_dtype=torch.float32, codec_dtype="float32",
                       device="cpu", top_k=1, max_gen_len=16, **kw)


@pytest.fixture(scope="module")
def serving_pair():
    jcfg, params, model = make_pair(prefix_mode=1, **TRAIN_SMALL)
    jtok = jax_audio_tokenizer()
    tok = AudioTokenizer(device="cpu")
    load_numpy_state_dict(tok.codec, encodec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtok.params)))
    return jcfg, params, model, jtok, tok


def _same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.frames == b.frames
        assert np.array_equal(a.codes, b.codes)


@pytest.mark.parametrize("decode_mode", ["exact", "unroll"])
def test_tp_synthesizer_matches_jax_tp_mesh(serving_pair, decode_mode):
    """fp32 greedy codes of the port's dp1 x tp2 mesh (two shard threads
    on the CPU) equal JAX's Synthesizer on a dp1 x tp2 mesh (GSPMD over
    the sharded parameters) and the port's mesh=None, bit for bit; the
    wavs equal JAX's to 1e-4."""
    jcfg, params, model, jtok, tok = serving_pair
    jsynth = JaxSynthesizer(
        ValleModel(jcfg), params, JaxTextTokenizer(backend="char"),
        JaxCollater(SYMBOLS), jtok, top_k=1, max_gen_len=16,
        compute_dtype=jnp.float32, codec_dtype="float32",
        decode_mode=decode_mode,
        mesh=jax_make_mesh(dp=1, tp=2, devices=jax.devices()[:2]))
    ref = jsynth.synthesize(_requests(JaxRequest), max_gen_len=12)
    one = _port_synth(model, tok, decode_mode=decode_mode).synthesize(
        _requests(SynthesisRequest), max_gen_len=12)
    synth = _port_synth(model, tok, decode_mode=decode_mode,
                        mesh=make_mesh(dp=1, tp=2, devices=["cpu", "cpu"]))
    out = synth.synthesize(_requests(SynthesisRequest), max_gen_len=12)
    _same(out, ref)
    _same(out, one)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=1e-4)
    assert synth.last_decode_mode == decode_mode
    # the shards hold the slices, the engine's own model stays whole
    shards = synth._shards.shards
    assert [s.model.model_shard.index for s in shards] == [0, 1]
    w = model.ar_decoder.layers[0].linear1.weight
    assert shards[1].model.ar_decoder.layers[0].linear1.weight.shape == (
        w.shape[0] // 2, w.shape[1])
    assert torch.equal(shards[1].model.ar_decoder.layers[0].linear1.weight,
                       w[w.shape[0] // 2:])


def test_tp_synthesizer_dp2_tp2(serving_pair):
    """A dp2 x tp2 mesh of four CPU shards: each data shard's two model
    shards sum apart from the other's; greedy codes of 3 requests (pad to
    4, 2 rows a data shard) and of a prenet VALL-F equal mesh=None's."""
    _, _, model, _, tok = serving_pair
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    ref = _port_synth(model, tok).synthesize(_requests(SynthesisRequest),
                                             max_gen_len=12)
    synth = _port_synth(model, tok, mesh=mesh)
    _same(synth.synthesize(_requests(SynthesisRequest), max_gen_len=12),
          ref)
    groups = [s.group for s in synth._shards.shards]
    assert groups[0] is groups[1] and groups[2] is groups[3]
    assert groups[0] is not groups[2]
    vallf = VALLE(ValleConfig(**TRAIN_SMALL, model_name="vallf",
                              add_prenet=True, prefix_mode=1),
                  generator=torch.Generator().manual_seed(0)).eval()
    ref = _port_synth(vallf, tok).synthesize(_requests(SynthesisRequest),
                                             max_gen_len=12)
    _same(_port_synth(vallf, tok, mesh=mesh).synthesize(
        _requests(SynthesisRequest), max_gen_len=12), ref)


def test_tp_refusals(serving_pair):
    """JAX's refusals stay: the kernel decode modes ("whole weight
    matrices") and the ContinuousBatcher ("DP-only") under a model axis;
    make_mesh refuses a device count that tp does not divide."""
    _, _, model, _, tok = serving_pair
    args = (model, TextTokenizer(backend="char"),
            TextTokenCollater(SYMBOLS), tok)
    tp2 = make_mesh(dp=1, tp=2, devices=["cpu", "cpu"])
    for mode in ("fused", "int8", "mega", "auto"):
        with pytest.raises(ValueError, match="whole weight matrices"):
            Synthesizer(*args, decode_mode=mode, mesh=tp2, device="cpu")
    with pytest.raises(ValueError, match="DP-only"):
        ContinuousBatcher(*args, slots=2, mesh=tp2, device="cpu")
    with pytest.raises(ValueError, match="does not divide devices"):
        make_mesh(tp=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=r"dp\(1\) \* tp\(2\) != devices"):
        make_mesh(dp=1, tp=2, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# training with two shard threads in one process
# ---------------------------------------------------------------------------

def _threads(fn, n=2):
    out, errs = [None] * n, []

    def run(j):
        try:
            out[j] = fn(j)
        except BaseException as e:   # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(j,)) for j in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive(), "a shard thread did not finish"
    if errs:
        raise errs[0]
    return out


def _pinned(model, micro, *, train_stage, generator, deterministic,
            compute_dtype):
    from valle_tpu_torch.models.valle import valle_forward

    return valle_forward(
        model, micro, train_stage=train_stage, generator=generator,
        deterministic=deterministic, compute_dtype=compute_dtype,
        nar_stage=TRAIN_PINS["nar_stage"],
        nar_prefix_len=TRAIN_PINS["nar_prefix_len"])


# The NAR tables tied to the NAR heads: their rows' gradients are sums
# over the logits that can sit near ScaledAdam's eps (1e-8), where a first
# step moves an element by an amount proportional to its gradient, round-
# off included (one element of 65536 moves 1.4e-6 apart in the dropout-
# off case); they are held as test_torch_port_distributed.py holds the
# same tables against JAX (PADDED: rtol 1e-3, atol 1e-4).
TIED = ({f"nar_audio_embeddings.{j}.word_embeddings.weight"
         for j in range(1, 8)}
        | {f"nar_predict_layers.{j}.weight" for j in range(6)})


def _step(model, steps=1, seed=7):
    opt, lr_fn = make_optimizer(model, train_stage=0, device="cpu")
    step = make_train_step(lr_fn, train_stage=0, forward_fn=_pinned,
                           device="cpu")
    state = TrainState(model, opt)
    outs = [step(state, train_batch(), 0,
                 torch.Generator().manual_seed(seed + i))
            for i in range(steps)]
    return outs, opt


@pytest.mark.parametrize("dropout", [False, True])
def test_tp2_step_equals_whole_step(dropout):
    """A ScaledAdam step of two shard threads (a ThreadGroup) equals the
    whole model's: loss and sums 1e-5, grad norm 1e-4, the gathered
    gradients 1e-5 of each tensor's largest entry, and the gathered
    parameters rtol 3e-5 (JAX's tolerances in
    tests/test_tp_equivalence.py; the tables tied to the NAR heads 1e-3,
    see ``TIED``). With dropout on, each shard's FFN
    mask is its slice of the whole mask, so the masks are one device's."""
    _, _, whole = make_pair(prefix_mode=1, **TRAIN_SMALL)
    whole.train()
    group = ThreadGroup(2)
    shards = sharded_copies(whole, [ModelShard(2, j, group)
                                    for j in range(2)], ["cpu", "cpu"])
    stack = no_dropout_seeds() if not dropout else None
    if stack is not None:
        stack.__enter__()
    try:
        want, _ = _step(whole)
        got = _threads(lambda j: _step(shards[j]))
    finally:
        if stack is not None:
            stack.__exit__(None, None, None)
    for outs, _ in got:
        for o, w in zip(outs, want):
            for k in w:
                tol = 1e-4 if k == "grad_norm" else 1e-5
                np.testing.assert_allclose(float(o[k]), float(w[k]),
                                           rtol=tol, err_msg=k)
    dims = shards[0].tp_dims
    grads = gather_state_dict([{n: p.grad for n, p in s.named_parameters()
                                if p.grad is not None} for s in shards], dims)
    for n, p in whole.named_parameters():
        if p.grad is not None:
            err = (grads[n] - p.grad).abs().max() / p.grad.abs().max()
            assert err <= 1e-5, (n, float(err))
    merged = gather_state_dict([s.state_dict() for s in shards], dims)
    for k, v in whole.state_dict().items():
        tol = (1e-3, 1e-4) if k in TIED else (3e-5, 1e-6)
        np.testing.assert_allclose(merged[k].numpy(), v.numpy(), rtol=tol[0],
                                   atol=tol[1], err_msg=k)
    # the shards' whole parameters stayed equal to each other
    for k, v in shards[0].state_dict().items():
        if k not in dims:
            assert torch.equal(v, shards[1].state_dict()[k]), k


def test_optimizer_state_gathers_whole():
    """The shards' ScaledAdam buffers gather whole: those of a split
    parameter are its shards' buffers put together in its whole shape,
    the others (per-tensor statistics, whole parameters' buffers) are
    equal on both shards; and they cut back into each shard's own."""
    _, _, whole = make_pair(prefix_mode=1, **TRAIN_SMALL)
    whole.train()
    group = ThreadGroup(2)
    shards = sharded_copies(whole, [ModelShard(2, j, group)
                                    for j in range(2)], ["cpu", "cpu"])
    with no_dropout_seeds():
        _, want = _step(whole)
        got = _threads(lambda j: _step(shards[j]))

    def names(m, opt):
        by_id = {id(p): n for n, p in m.named_parameters()}
        ps = [p for g in opt.param_groups for p in g["params"]]
        return ps, [by_id[id(p)] for p in ps]

    gathered = _threads(lambda j: gather_optimizer_state(
        got[j][1].state_dict(), *names(shards[j], got[j][1]),
        shards[j].tp_dims, shards[j].model_shard))
    ref = want.state_dict()
    _, ref_names = names(whole, want)
    own = [got[j][1].state_dict()["state"] for j in range(2)]
    assert gathered[0]["state"].keys() == ref["state"].keys()
    for i, st in ref["state"].items():
        d = shards[0].tp_dims.get(ref_names[i])
        for k, v in st.items():
            for g in gathered:
                have = g["state"][i][k]
                assert have.shape == v.shape, (i, k)
                if d is not None and v.shape == whole.get_parameter(
                        ref_names[i]).shape:
                    assert torch.equal(have, torch.cat(
                        [o[i][k] for o in own], dim=d)), (i, k)
                else:
                    assert torch.equal(have, own[0][i][k]), (i, k)
                    assert torch.equal(have, own[1][i][k]), (i, k)
    for j in range(2):
        back = shard_optimizer_state(gathered[0], *names(shards[j],
                                                         got[j][1]),
                                     shards[j].tp_dims,
                                     shards[j].model_shard)
        own = got[j][1].state_dict()
        for i, st in own["state"].items():
            for k, v in st.items():
                assert torch.equal(back["state"][i][k], v), (j, i, k)


def test_eve_decays_by_the_whole_tensor():
    """Eve decays a split parameter by its whole tensor's norm: a (4, 8)
    weight whose first two rows are large and last two small decays on
    both shards (the whole norm is over target_rms x sqrt(32)), though
    the small shard alone would not; the two shards' steps put together
    equal the whole tensor's."""
    from valle_tpu_torch.optim.eve import Eve

    whole = torch.cat([torch.ones(2, 8), torch.full((2, 8), 1e-3)])
    grad = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    group = ThreadGroup(2)

    def step(p, g, **kw):
        p = torch.nn.Parameter(p.clone())
        p.grad = g.clone()
        Eve([p], lr=1e-2, weight_decay=0.5, **kw).step()
        return p.detach()

    want = step(whole, grad)
    got = _threads(lambda j: step(whole[2 * j:2 * j + 2],
                                  grad[2 * j:2 * j + 2], sharded=[True],
                                  model_shard=ModelShard(2, j, group)))
    assert torch.allclose(torch.cat(got), want, rtol=1e-6, atol=0)
    alone = step(whole[2:], grad[2:])
    assert not torch.allclose(alone, got[1], rtol=1e-6, atol=0)


def test_thread_group_sums_under_contention():
    """16 shard threads (more than the host's cores), the interpreter
    switching threads every microsecond, 50 sums in a row: every shard
    gets every round's whole sum, added in shard order."""
    import sys

    n, rounds = 16, 50
    group = ThreadGroup(n)

    def shard(j):
        return [group.all_reduce(torch.tensor([float(j + r * n)]), j).item()
                for r in range(rounds)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _threads(shard, n)
    finally:
        sys.setswitchinterval(interval)
    want = [float(sum(j + r * n for j in range(n))) for r in range(rounds)]
    assert all(g == want for g in got)
