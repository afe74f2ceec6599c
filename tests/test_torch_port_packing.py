"""Sequence packing in the port against the JAX package, on the CPU: the
packed masks and flash codes bit for bit, the gather positional encoding,
the packed AR and NAR forwards (fp32, dropout off, draws pinned; both
attention routes, the flash one through B4/B5's plain versions and JAX's
kernel in interpret mode) in loss, metrics and gradients, the sampler's
rows and the packed datasets' arrays. Port-only: a packed row's loss is
the sum of its segments' exact-length forwards, and padding (an empty
row, the row tails) stays finite and adds no loss."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from valle_tpu.data import packing as jax_packing
from valle_tpu.data.collation import get_text_token_collater as jax_collater
from valle_tpu.data.manifests import CutSet as JaxCutSet
from valle_tpu.models import ValleConfig as JaxValleConfig
from valle_tpu.models import valle as jax_valle
from valle_tpu.modules import embedding as jax_emb
from valle_tpu.ops import masks as jax_masks
from valle_tpu_torch.data import packing
from valle_tpu_torch.data.collation import get_text_token_collater
from valle_tpu_torch.data.manifests import CutSet
from valle_tpu_torch.models import valle
from valle_tpu_torch.modules.embedding import (apply_sine_positional_gather,
                                               sine_positional_table)
from valle_tpu_torch.ops import masks
from valle_tpu_torch.ops.flash_mha import reference_mha
from valle_tpu_torch.utils.convert import valle_state_dict_from_jax

from torch_port_corpus import write_corpus
from torch_port_helpers import _jax_params, make_pair, t

SMALL = dict(d_model=64, nhead=4, num_layers=2, num_quantizers=8,
             max_len=256)
S, T = 32, 64                  # a packed row's text and audio capacity
PINS = dict(nar_stage=3, nar_prefix_len=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("port_packing"), n_train=12,
                        n_dev=1, train_frames=(6, 28), text_len=(2, 9),
                        seed=5)


def _cuts(corpus, cutset=CutSet):
    return list(cutset.from_file(corpus / "cuts_train.jsonl.gz"))


def _rows(cuts):
    """Three packed rows: two segments, three, and an empty one."""
    return [cuts[0:2], cuts[2:5], []]


def _datasets(corpus):
    tokens = str(corpus / "unique_text_tokens.k2symbols")
    port = (packing.PackedSpeechDataset(get_text_token_collater(tokens)),
            packing.PackedNarSpeechDataset(get_text_token_collater(tokens),
                                           max_segments=8))
    jax_ = (jax_packing.PackedSpeechDataset(jax_collater(tokens)),
            jax_packing.PackedNarSpeechDataset(jax_collater(tokens),
                                               max_segments=8))
    return port, jax_


def _batch(corpus, kind):
    (ar, nar), _ = _datasets(corpus)
    ds = ar if kind == "ar" else nar
    out = ds.__getitem__(_rows(_cuts(corpus)), pad_audio_to=T, pad_text_to=S)
    out.pop("utt_id")
    return out


def _random_segments(seed):
    """(text_seg, audio_seg) of 3 rows: segments of random lengths, padded
    tails, and an all-padding row."""
    rng = np.random.RandomState(seed)
    text_seg = np.full((3, 12), -1, np.int32)
    audio_seg = np.full((3, 20), -1, np.int32)
    for r in range(2):
        s_off = t_off = 0
        for si in range(int(rng.randint(1, 4))):
            L, Lf = int(rng.randint(1, 4)), int(rng.randint(1, 6))
            text_seg[r, s_off:s_off + L] = si
            audio_seg[r, t_off:t_off + Lf] = si
            s_off, t_off = s_off + L, t_off + Lf
    return text_seg, audio_seg


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_match_jax(seed):
    text_seg, audio_seg = _random_segments(seed)
    for name in ("packed_ar_attn_bias", "packed_nar_attn_bias",
                 "flash_codes_packed_ar", "flash_codes_packed_nar"):
        got = getattr(masks, name)(t(text_seg), t(audio_seg))
        want = getattr(jax_masks, name)(jnp.asarray(text_seg),
                                        jnp.asarray(audio_seg))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.array(b)
            assert a.dtype == torch.from_numpy(b).dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_padding_sees_only_its_diagonal():
    """Under the packed codes a padded query sees its own key alone: the
    plain flash output there is its own value row, finite."""
    text_seg, audio_seg = _random_segments(0)
    qc, kc, qs, ks = masks.flash_codes_packed_ar(t(text_seg), t(audio_seg))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 2, 32, 16, generator=g) for _ in range(3))
    out = reference_mha(q, k, v, qc, kc, qseg=qs, kseg=ks, add_diag=True)
    pad = torch.from_numpy(np.concatenate([text_seg, audio_seg], 1) < 0)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.permute(0, 2, 1, 3)[pad],
                               v.permute(0, 2, 1, 3)[pad])


def test_sine_positional_gather_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 16).astype(np.float32)
    pos = rng.randint(-1, 30, (2, 10)).astype(np.int32)
    pe = sine_positional_table(64, 16)
    got = apply_sine_positional_gather(torch.tensor([0.7]), t(x), pe, t(pos))
    want = jax_emb.apply_sine_positional_gather(
        {"alpha": jnp.asarray([0.7], jnp.float32)}, jnp.asarray(x),
        jnp.asarray(pe.numpy()), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _jax_packed(kind, batch, prefix_mode, attn_impl):
    """JAX's packed forward (fp32, deterministic, draws pinned): (loss,
    metrics, gradients under the port's state-dict names)."""
    jcfg = JaxValleConfig(prefix_mode=prefix_mode, attn_impl=attn_impl,
                          **SMALL)
    params = _jax_params(0, dataclasses.replace(
        jcfg, prefix_mode=0, attn_impl="einsum"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "ar":
        fwd, pins = jax_valle.valle_ar_forward_packed, {}
    else:
        fwd = jax_valle.valle_nar_forward_packed
        pins = {k: jnp.int32(v) for k, v in PINS.items()}

    def f(p):
        loss, metrics, _ = fwd(p, jcfg, jb, deterministic=True, **pins)
        return loss, metrics

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            valle_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, grads), jcfg))


@pytest.mark.parametrize("kind,prefix_mode,attn_impl", [
    ("ar", 0, "einsum"), ("ar", 0, "flash"),
    ("nar", 0, "einsum"), ("nar", 1, "einsum"), ("nar", 1, "flash")])
def test_packed_forward_matches_jax(corpus, kind, prefix_mode, attn_impl):
    """Loss and metrics within 1e-5 relative, gradients within 1e-4 of each
    tensor's largest entry."""
    batch = _batch(corpus, kind)
    jloss, jmetrics, jgrads = _jax_packed(kind, batch, prefix_mode,
                                          attn_impl)
    _, _, model = make_pair(prefix_mode=prefix_mode, attn_impl=attn_impl,
                            **SMALL)
    if kind == "ar":
        loss, metrics = valle.valle_ar_forward_packed(
            model, {k: t(v) for k, v in batch.items()}, deterministic=True)
    else:
        loss, metrics = valle.valle_nar_forward_packed(
            model, {k: t(v) for k, v in batch.items()}, deterministic=True,
            **PINS)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for name, p in model.named_parameters():
        if p.requires_grad:
            got = p.grad if p.grad is not None else torch.zeros_like(p)
            want = jgrads[name]
            assert bool(torch.isfinite(got).all()), name
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-4,
                atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=name)


def _exact_length_batch(cut, collater):
    """One cut as a bucketed batch of one row at its exact lengths."""
    ids, lens = collater.index([cut.tokens])
    codes = cut.load_features().astype(np.int64)
    return {"text": t(ids), "text_lens": t(lens),
            "audio": torch.from_numpy(codes)[None],
            "audio_lens": torch.tensor([codes.shape[0]])}


@pytest.mark.parametrize("kind", ["ar", "nar"])
def test_packed_loss_is_the_sum_of_exact_length_forwards(corpus, kind):
    """The port's packed loss equals the sum of its segments' unpacked
    losses at their exact lengths (the NAR with stage and prefix pinned);
    the empty row and the row tails add nothing."""
    _, _, model = make_pair(prefix_mode=1, **SMALL)
    collater = get_text_token_collater(
        str(corpus / "unique_text_tokens.k2symbols"))
    cuts = [c for row in _rows(_cuts(corpus)) for c in row]
    stage, key = (1, "ar_loss") if kind == "ar" else (2, "nar_loss")
    with torch.no_grad():
        want = sum(valle.valle_forward(
            model, _exact_length_batch(c, collater), train_stage=stage,
            deterministic=True, **PINS)[1][key].item() for c in cuts)
        batch = {k: t(v) for k, v in _batch(corpus, kind).items()}
        if kind == "ar":
            loss, metrics = valle.valle_ar_forward_packed(
                model, batch, deterministic=True)
        else:
            # mode 1's loss scale is total / (total - prefix * segments)
            # over the packed batch, the bucketed one's over its row
            model.cfg = dataclasses.replace(model.cfg, prefix_mode=0)
            want = sum(valle.valle_forward(
                model, _exact_length_batch(c, collater), train_stage=2,
                deterministic=True, **PINS)[1][key].item() for c in cuts)
            loss, metrics = valle.valle_nar_forward_packed(
                model, batch, deterministic=True, **PINS)
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    assert metrics["utterances"].item() == len(cuts)
    assert metrics["frames"].item() == sum(c.features.num_frames
                                           for c in cuts)


def test_sampler_matches_jax(corpus):
    """The same rows for the same seed and epoch, under a rank split, and
    after a resume."""
    kw = dict(max_frames=40, max_text=24, rows_per_batch=1, seed=3)
    for extra in ({}, {"world_size": 2, "rank": 1}):
        mine = packing.SequencePackingSampler(CutSet(_cuts(corpus)),
                                              **kw, **extra)
        ref = jax_packing.SequencePackingSampler(
            JaxCutSet(_cuts(corpus, JaxCutSet)), **kw, **extra)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = [[[c.id for c in row] for row in b.cuts] for b in mine]
            want = [[[c.id for c in row] for row in b.cuts] for b in ref]
            assert got == want and len(got) > 1
            assert mine.state_dict() == ref.state_dict()
        sd = dict(mine.state_dict(), consumed=1)
        mine.load_state_dict(sd)
        ref.load_state_dict(sd)
        assert ([b.pad_audio_to for b in mine]
                == [b.pad_audio_to for b in ref])
        assert mine.state_dict() == ref.state_dict()


def test_packed_datasets_match_jax(corpus):
    (ar, nar), (jar, jnar) = _datasets(corpus)
    rows, jrows = _rows(_cuts(corpus)), _rows(_cuts(corpus, JaxCutSet))
    for mine, ref in ((ar, jar), (nar, jnar)):
        got = mine.__getitem__(rows, pad_audio_to=T, pad_text_to=S)
        want = ref.__getitem__(jrows, pad_audio_to=T, pad_text_to=S)
        assert got.keys() == want.keys()
        for k in got:
            if k == "utt_id":
                assert got[k] == want[k]
            else:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = ar.__getitem__(rows, pad_audio_to=T, pad_text_to=S)
    assert (got["ar_targets"][got["audio_seg"] < 0] == -1).all()
    assert (got["ar_targets"][2] == -1).all()
