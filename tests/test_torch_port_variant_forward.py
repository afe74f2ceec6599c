"""The port's training forward for VALL-F, prenets and post-norm stacks
against the JAX package's ``valle_forward`` (fp32, 2 layers, d 64, the
NAR draws pinned, dropout 0): losses to 1e-5 relative, top-10 accuracies
to 1e-5, and the prenets' BatchNorm statistics after the forward equal
JAX's ``new_state`` to 1e-6 relative. "Training" is ``deterministic``
False with no random draws: batch statistics, no dropout mask. JAX's
positional dropout cannot run without a key there, so its embedding
``dropout`` is wrapped, for these tests alone, to draw nothing when the
key is None, as its prenets already do."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import valle_tpu.modules.embedding as jax_embedding
from valle_tpu.models import valle_forward as jax_forward
from valle_tpu_torch.models.valle import valle_forward

from torch_port_helpers import (TRAIN_PINS, TRAIN_SMALL, VARIANTS,
                                make_variant, statistics_of, t, train_batch)

# stage 1 does not depend on the prefix mode: once a variant; every
# prefix mode for VALL-F and for prenets + post-norm, one case of the
# combination, and the running statistics (deterministic) at two cases
CASES = ([(v, s, m, False) for v in ("vallf", "prenet_postnorm")
          for s, m in ((1, 0), (2, 0), (2, 1), (2, 2), (2, 4))]
         + [("vallf_prenet_postnorm", 2, 2, False)]
         + [("prenet_postnorm", s, m, True) for s, m in ((1, 0), (2, 1))])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the trainer tests run: beside the other
    test workers, many small ops on several threads each mostly wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_draw_without_key(monkeypatch):
    draw = jax_embedding.dropout

    def dropout(x, rate, rng, deterministic=False):
        return x if rng is None else draw(x, rate, rng, deterministic)

    monkeypatch.setattr(jax_embedding, "dropout", dropout)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("variant,stage,prefix_mode,deterministic", CASES)
def test_forward_matches_jax(variant, stage, prefix_mode, deterministic):
    kw = dict(TRAIN_SMALL, dropout=0.0, prefix_mode=prefix_mode,
              **VARIANTS[variant])
    jcfg, params, state, model = make_variant(**kw)
    batch = train_batch(prefix_mode=prefix_mode)
    jloss, jmetrics, jstate = jax_forward(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        train_stage=stage, deterministic=deterministic, state=state,
        **{k: jnp.asarray(v) for k, v in TRAIN_PINS.items()})
    before = statistics_of(model)
    loss, metrics = valle_forward(
        model, {k: t(v) for k, v in batch.items()}, train_stage=stage,
        deterministic=deterministic,
        **{k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in TRAIN_PINS.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    after = statistics_of(model)
    branch = "ar" if stage == 1 else "nar"
    for (b, i), (mean, var) in after.items():
        want = jstate[b]["text_prenet"][f"bn{i}"]
        assert _rel(mean, want["mean"]) < 1e-6, (b, i)
        assert _rel(var, want["var"]) < 1e-6, (b, i)
        moved = not np.array_equal(var, before[(b, i)][1])
        # once, in the branch that ran, and never when deterministic
        assert moved == (b == branch and not deterministic), (b, i)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
