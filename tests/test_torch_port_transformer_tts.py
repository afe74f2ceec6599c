"""The port's Transformer TTS (``valle_tpu_torch/models/transformer.py``)
against ``valle_tpu/models/transformer.py`` on the CPU, on JAX's seeded
weights carried over by ``transformer_tts_state_dict_from_jax`` (loaded
with ``strict=True``), for every ``scaling_xformers`` x ``norm_first`` x
``add_prenet`` setting the model takes (d 32, 2 heads, 2 layers, 12 mel
bins, fp32, one intra-op thread):

- the deterministic loss and metrics (1e-5) and every parameter's
  gradient (1e-4 of its largest entry);
- ``transformer_visualize_outputs`` (1e-5);
- the greedy inference mel (1e-5 of its largest entry) and ``lens``, with
  the stop head's bias at -30 so the length rule stops the lanes: the lane
  with one text token stops at frame 11, the others run the whole budget.
  With prenets the port applies the encoder prenet in inference, as its
  forward and the reference do; JAX's inference leaves it out (ROADMAP
  C13), so there the JAX loop is traced with its own prenet patched in
  front of the positions (each case's configuration is traced once).

And ``valle_visualize_outputs`` against JAX's on a small VALL-E."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.models import ValleConfig as JaxValleConfig
from valle_tpu.models import init_valle
from valle_tpu.models import transformer as jtr
from valle_tpu.models.valle import valle_visualize_outputs as jax_vis
from valle_tpu.modules import embedding as jemb
from valle_tpu.modules import prenet as jpre
from valle_tpu_torch.models.transformer import (TransformerTtsConfig,
                                                TransformerTtsModel,
                                                transformer_tts_forward,
                                                transformer_visualize_outputs)
from valle_tpu_torch.models.valle import (VALLE, ValleConfig,
                                          valle_visualize_outputs)
from valle_tpu_torch.utils.convert import (load_numpy_state_dict,
                                           transformer_tts_state_dict_from_jax,
                                           valle_state_dict_from_jax)

SMALL = dict(d_model=32, nhead=2, num_layers=2, num_mel_bins=12,
             max_len=256)
CASES = [(sx, nf, ap) for sx in (False, True) for nf in (True, False)
         for ap in (False, True) if not (sx and ap)]
GEN = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.RandomState(0)
    return {"text": rng.randint(3, 60, (3, 9)).astype(np.int32),
            "text_lens": np.array([9, 4, 7], np.int32),
            "audio": rng.randn(3, 14, SMALL["num_mel_bins"]).astype(
                np.float32),
            "audio_lens": np.array([14, 8, 11], np.int32)}


def _pair(sx, nf, ap):
    """(JAX cfg, params, state, port model) on the same weights; the
    prenet's statistics seeded, the stop bias at -30."""
    kw = dict(SMALL, scaling_xformers=sx, norm_first=nf, add_prenet=ap)
    jcfg = jtr.TransformerTtsConfig(**kw)
    params, state = jtr.init_transformer_tts(jax.random.PRNGKey(1), jcfg)
    params["stop"]["b"] = jnp.full((1,), -30.0)
    rng = np.random.RandomState(3)
    state = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32),
        state)
    model = TransformerTtsModel(TransformerTtsConfig(**kw))
    np_tree = jax.tree_util.tree_map(np.asarray, (params, state))
    load_numpy_state_dict(model, transformer_tts_state_dict_from_jax(
        np_tree[0], jcfg, np_tree[1]))
    return jcfg, params, state, model.eval()


def close(got, want, limit, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= limit, (what, err)


@pytest.mark.parametrize("sx,nf,ap", CASES)
def test_transformer_tts_matches_jax(sx, nf, ap, monkeypatch):
    jcfg, params, state, model = _pair(sx, nf, ap)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}

    @jax.jit
    def jloss(p):
        loss, m, _ = jtr.transformer_tts_forward(p, jcfg, jb,
                                                 deterministic=True,
                                                 state=state)
        return loss, m

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    loss, m = transformer_tts_forward(model, tb, deterministic=True)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert m.keys() == {"stop_loss", "stop_accuracy", "frames"}
    for k in m:
        assert m[k].item() == pytest.approx(float(jm[k]), rel=1e-5), k
    loss.backward()
    want = transformer_tts_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), jcfg)
    n = 0
    for name, p in model.named_parameters():
        if p.requires_grad:
            close(p.grad, want[name], 1e-4, name)
            n += 1
    assert n == sum(p.requires_grad for p in model.parameters())

    enc, pred = transformer_visualize_outputs(model, tb)
    jenc, jpred = jax.jit(jtr.transformer_visualize_outputs,
                          static_argnums=1)(params, jcfg, jb, state)
    close(enc, jenc, 1e-5, "encoder_out")
    close(pred, jpred, 1e-5, "predict")

    if ap:
        class WithPrenet:     # JAX's inference with its encoder prenet
            def __getattr__(self, name):
                return getattr(jemb, name)

            def token_embedding(self, p, ids, dtype=None):
                x = jemb.token_embedding(p, ids, dtype=dtype)
                return jpre.text_prenet(params["encoder_prenet"],
                                        state["encoder_prenet"], x,
                                        training=False)[0]

        monkeypatch.setattr(jtr, "emb", WithPrenet())
    lens = np.array([9, 1, 7], np.int32)
    jmel, jlens = jtr.transformer_tts_inference(
        params, jcfg, jb["text"], jnp.asarray(lens), max_gen_len=GEN)
    mel, tlens = model.inference(tb["text"], torch.as_tensor(lens),
                                 max_gen_len=GEN)
    assert tlens.tolist() == np.asarray(jlens).tolist() == [GEN, 11, GEN]
    close(mel, jmel, 1e-5, "mel")
    assert not mel[1, 11:].any()


def test_valle_visualize_outputs():
    jcfg = JaxValleConfig(d_model=32, nhead=2, num_layers=1, max_len=64)
    params = jax.jit(init_valle, static_argnums=1)(jax.random.PRNGKey(2),
                                                   jcfg)[0]
    model = VALLE(ValleConfig(d_model=32, nhead=2, num_layers=1, max_len=64))
    load_numpy_state_dict(model, valle_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jcfg))
    rng = np.random.RandomState(4)
    b = {"text": rng.randint(3, 60, (2, 12)).astype(np.int32),
         "audio": rng.randint(0, 1024, (2, 20, 8)).astype(np.int32)}
    enc, codes = valle_visualize_outputs(
        model, {k: torch.as_tensor(v) for k, v in b.items()})
    jenc, jcodes = jax.jit(jax_vis, static_argnums=1)(
        params, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    close(enc, jenc, 1e-6, "encoder")
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
