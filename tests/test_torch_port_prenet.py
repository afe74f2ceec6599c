"""The port's prenets and its post-norm and cross-attending stacks at the
module level, against the JAX package on the CPU (fp32, seeded numpy
inputs, 2 layers, d 64, 4 heads): the prenets' outputs and their
BatchNorm statistics after a training call and after a deterministic one
(1e-6 relative), the decoder stack pre- and post-norm (1e-5), the
post-norm encoder stack; the fused decode modes refused for post-norm
stacks; the statistics kept fp32 under a cast and restored by
``kept_statistics``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.modules import prenet as jpre
from valle_tpu.modules import transformer as jtfm
from valle_tpu_torch.modules import prenet as pre
from valle_tpu_torch.modules.transformer import (
    FUSED_MODES, TransformerDecoder, TransformerEncoder, decoder_stack_apply,
    encoder_stack_apply, encoder_stack_decode_step, encoder_stack_prefill)
from valle_tpu_torch.ops import masks as M

from torch_port_helpers import t

D, H, L = 64, 4, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the trainer tests run: beside the other
    test workers, many small ops on several threads each mostly wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_text_prenet(seed=0):
    p, s = jpre.init_text_prenet(jax.random.PRNGKey(seed), D)
    # non-default statistics, so the deterministic call reads real ones
    rng = np.random.RandomState(seed)
    s = {k: {"mean": jnp.asarray(rng.randn(D).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2, D).astype(np.float32))}
         for k in s}
    return p, s


def _port_text_prenet(p, s):
    m = pre.TextPrenet(D)
    convs, out = m.layers()
    with torch.no_grad():
        for i, (conv, bn) in enumerate(convs):
            conv.weight.copy_(t(np.transpose(np.asarray(p[f"conv{i}"]["w"]),
                                             (2, 1, 0))))
            conv.bias.copy_(t(p[f"conv{i}"]["b"]))
            bn.weight.copy_(t(p[f"bn{i}"]["scale"]))
            bn.bias.copy_(t(p[f"bn{i}"]["bias"]))
            bn.running_mean.copy_(t(s[f"bn{i}"]["mean"]))
            bn.running_var.copy_(t(s[f"bn{i}"]["var"]))
        out.weight.copy_(t(np.asarray(p["out"]["w"]).T))
        out.bias.copy_(t(p["out"]["b"]))
    return m


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("training", [True, False])
def test_text_prenet_and_statistics_match_jax(training):
    p, s = _jax_text_prenet()
    x = np.random.RandomState(1).randn(3, 11, D).astype(np.float32)
    want, new = jpre.text_prenet(p, s, jnp.asarray(x), training=training)
    m = _port_text_prenet(p, s)
    got = pre.text_prenet(m, t(x), training=training)
    assert _rel(got.detach().numpy(), want) < 1e-5
    convs, _ = m.layers()
    for i, (_, bn) in enumerate(convs):
        assert _rel(bn.running_mean.numpy(), new[f"bn{i}"]["mean"]) < 1e-6
        assert _rel(bn.running_var.numpy(), new[f"bn{i}"]["var"]) < 1e-6
        assert int(bn.num_batches_tracked) == int(training)
        assert bn.running_var.dtype == torch.float32


def test_audio_prenet_matches_jax():
    p = jpre.init_audio_prenet(jax.random.PRNGKey(2), D)
    m = pre.AudioPrenet(D)
    with torch.no_grad():
        for i, lin in enumerate(m.linears()):
            lin.weight.copy_(t(np.asarray(p[f"lin{i}"]["w"]).T))
            lin.bias.copy_(t(p[f"lin{i}"]["b"]))
    x = np.random.RandomState(3).randn(2, 7, D).astype(np.float32)
    want = jpre.audio_prenet(p, jnp.asarray(x), training=False)
    assert _rel(pre.audio_prenet(m, t(x)).detach().numpy(), want) < 1e-5
    # pointwise: a decode step's (B, d) rows give the same rows
    step = pre.audio_prenet(m, t(x[:, 3]))
    assert _rel(step.detach().numpy(), np.asarray(want)[:, 3]) < 1e-5


def test_statistics_stay_fp32_and_kept_statistics_restores():
    p, s = _jax_text_prenet()
    m = _port_text_prenet(p, s)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pre.kept_statistics(m):
        pre.text_prenet(m, torch.randn(2, 9, D), training=True)
        assert not torch.equal(m.state_dict()["2.running_mean"],
                               before["2.running_mean"])
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    m = m.to(torch.bfloat16)
    assert m.state_dict()["6.weight"].dtype == torch.bfloat16
    for k in ("6.running_mean", "6.running_var"):
        assert m.state_dict()[k].dtype == torch.float32
        assert torch.equal(m.state_dict()[k], before[k])
    y = pre.text_prenet(m, torch.randn(2, 9, D, dtype=torch.bfloat16),
                        training=False)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()


def _jax_stack(decoder, adaptive, seed=0):
    init = jtfm.init_decoder_stack if decoder else jtfm.init_encoder_stack
    return init(jax.random.PRNGKey(seed), L, D, H, 4 * D, adaptive, True)


def _port_stack(jp, decoder, adaptive, norm_first):
    """The port's stack with JAX's weights (its final norm dropped for a
    post-norm stack, as JAX builds it with final_norm=cfg.norm_first)."""
    from valle_tpu_torch.utils.convert import _index_tree

    cls = TransformerDecoder if decoder else TransformerEncoder
    m = cls(L, D, H, 4 * D, adaptive=adaptive, norm_first=norm_first)
    lay = _np(jp["layers"])

    def norm(mod, n):
        if adaptive:
            mod.project_layer.weight.copy_(t(n["proj"]["w"].T))
            mod.project_layer.bias.copy_(t(n["proj"]["b"]))
            n = n["norm"]
            mod = mod.norm
        mod.weight.copy_(t(n["scale"]))
        mod.bias.copy_(t(n["bias"]))

    def attn(mod, a, i):
        mod.in_proj_weight.copy_(t(a["in_w"][i].T))
        mod.in_proj_bias.copy_(t(a["in_b"][i]))
        mod.out_proj.weight.copy_(t(a["out_w"][i].T))
        mod.out_proj.bias.copy_(t(a["out_b"][i]))

    with torch.no_grad():
        for i, layer in enumerate(m.layers):
            attn(layer.self_attn, lay["self_attn"], i)
            if decoder:
                attn(layer.multihead_attn, lay["cross_attn"], i)
            ff = lay["ffn"]
            layer.linear1.weight.copy_(t(ff["lin1"]["w"][i].T))
            layer.linear1.bias.copy_(t(ff["lin1"]["b"][i]))
            layer.linear2.weight.copy_(t(ff["lin2"]["w"][i].T))
            layer.linear2.bias.copy_(t(ff["lin2"]["b"][i]))
            for nm in ("norm1", "norm2") + (("norm3",) if decoder else ()):
                norm(getattr(layer, nm), _index_tree(lay[nm], i))
        if norm_first:
            norm(m.norm, _np(jp["final_norm"]))
    return m


@pytest.mark.parametrize("norm_first", [True, False], ids=["pre", "post"])
def test_decoder_stack_matches_jax(norm_first):
    """The cross-attending stack with AdaLN (the NAR's), padded memory
    keys and a causal self mask."""
    jp = _jax_stack(True, True)
    if not norm_first:
        jp = {"layers": jp["layers"]}
    m = _port_stack(jp, True, True, norm_first)
    rng = np.random.RandomState(4)
    B, T, S = 2, 9, 6
    x = rng.randn(B, T, D).astype(np.float32)
    mem = rng.randn(B, S, D).astype(np.float32)
    cond = rng.randn(1, D).astype(np.float32)
    y_lens, x_lens = np.array([9, 6]), np.array([6, 3])
    self_bias = M.causal_bias(T) + M.key_padding_bias(t(y_lens), T)
    cross = M.key_padding_bias(t(x_lens), S)
    want = jtfm.decoder_stack_apply(
        jp, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(self_bias.numpy()),
        jnp.asarray(cross.numpy()), jnp.asarray(cond), nhead=H,
        norm_first=norm_first)
    got = decoder_stack_apply(m, t(x), t(mem), self_bias, cross, t(cond))
    assert _rel(got.detach().numpy(), want) < 1e-5


@torch.no_grad()
def test_post_norm_encoder_prefill_and_step_match_jax():
    """A post-norm encoder stack: the full forward, the prefill's hidden
    states and cache, and a decode step at per-row positions."""
    jp = {"layers": _jax_stack(False, False)["layers"]}
    m = _port_stack(jp, False, False, False)
    rng = np.random.RandomState(5)
    B, T, C = 2, 7, 12
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([7, 5])
    bias = M.key_padding_bias(t(lens), T)
    want = jtfm.encoder_stack_apply(jp, jnp.asarray(x),
                                    jnp.asarray(bias.numpy()), nhead=H,
                                    norm_first=False)
    assert _rel(encoder_stack_apply(m, t(x), bias).numpy(), want) < 1e-5
    jh, jc = jtfm.encoder_stack_prefill(jp, jnp.asarray(x),
                                        jnp.asarray(bias.numpy()), nhead=H,
                                        cache_len=C, norm_first=False)
    h, cache = encoder_stack_prefill(m, t(x), bias, cache_len=C)
    assert _rel(h.numpy(), jh) < 1e-5
    assert _rel(cache["k"].numpy(), jc["k"]) < 1e-5
    xs = rng.randn(B, 1, D).astype(np.float32)
    pos = np.array([7, 5])
    kk = np.arange(C)[None, :]
    sb = np.where((kk < lens[:, None]) | (kk == pos[:, None]), 0.0,
                  -np.inf).astype(np.float32)[:, None, None, :]
    jh2, _ = jtfm.encoder_stack_decode_step(
        jp, jnp.asarray(xs), jc, jnp.asarray(pos), jnp.asarray(sb), nhead=H,
        norm_first=False)
    h2 = encoder_stack_decode_step(m, t(xs), cache, t(pos), t(sb))
    assert _rel(h2.numpy(), jh2) < 1e-5


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_modes_refuse_post_norm(mode):
    """JAX asserts that the fused kernels take pre-norm layers; the port
    raises a ValueError naming the mode, before any kernel runs."""
    m = TransformerEncoder(L, 128, H, 512, adaptive=False, norm_first=False)
    with pytest.raises(ValueError, match=f"decode mode '{mode}'.*post-norm"):
        encoder_stack_decode_step(m, torch.zeros(1, 1, 128), {}, 0, None,
                                  mode=mode)
