"""Remat policies of the port's training forward: "full", "dots" and
"scores" give remat "none"'s loss and gradients bit for bit at fp32 with
dropout on, on the einsum route and on the flash route (its plain version
on the CPU), and recompute what they say they do."""

import collections
import copy
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from valle_tpu_torch.models import resolve_remat
from valle_tpu_torch.models.valle import VALLE, ValleConfig, valle_forward
from valle_tpu_torch.ops import flash_mha

POLICIES = ("none", "full", "dots", "scores")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the many small ops of these runs do not wait
    on cores shared with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    g = torch.Generator().manual_seed(0)
    return {"text": torch.randint(3, 60, (2, 9), generator=g),
            "text_lens": torch.tensor([9, 6]),
            "audio": torch.randint(0, 1024, (2, 21, 8), generator=g),
            "audio_lens": torch.tensor([21, 15])}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _run(model, remat, stage, batch):
    """(loss, grads, backward op counts) under one remat policy."""
    m = copy.deepcopy(model)
    m.cfg = dataclasses.replace(m.cfg, remat=remat)
    loss, _ = valle_forward(m, batch, train_stage=stage,
                            generator=torch.Generator().manual_seed(5))
    ops = _OpCount()
    with ops:
        loss.backward()
    grads = {n: p.grad for n, p in m.named_parameters()
             if p.grad is not None}
    return loss.item(), grads, ops.count


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_remat_policies_match_none(attn_impl, monkeypatch):
    model = VALLE(ValleConfig(d_model=64, nhead=4, num_layers=2,
                              prefix_mode=1, attn_impl=attn_impl),
                  generator=torch.Generator().manual_seed(1))
    calls = [0]
    plain = flash_mha.reference_mha

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(flash_mha, "reference_mha", counted)
    batch = _batch()
    for stage in (1, 2):
        runs = {}
        for remat in POLICIES:
            calls[0] = 0
            runs[remat] = _run(model, remat, stage, batch)
            # the flash forward (plain here, B4 on the card) runs once a
            # layer, and again in the backward under every policy but
            # "none": it is one call under attention_scores
            if attn_impl == "flash":
                assert calls[0] == 2 * (1 if remat == "none" else 2)
        loss, grads, ops = runs["none"]
        assert grads and all(torch.isfinite(g).all() for g in grads.values())
        for remat in POLICIES[1:]:
            assert runs[remat][0] == loss, remat
            assert runs[remat][1].keys() == grads.keys()
            for n in grads:
                assert torch.equal(runs[remat][1][n], grads[n]), (remat, n)
        # what each policy recomputes in the backward (2 layers): "dots"
        # no matrix product, "scores" only the score product q.k^T of the
        # einsum route (all of the flash call on its route), "full" all
        full, dots, scores = (runs[r][2] for r in ("full", "dots",
                                                   "scores"))
        assert dots["mm"] == ops["mm"] and dots["bmm"] == ops["bmm"]
        assert scores["mm"] == ops["mm"]
        assert scores["bmm"] == ops["bmm"] + (2 if attn_impl == "einsum"
                                              else 4)
        assert full["mm"] > ops["mm"] and full["bmm"] == ops["bmm"] + 4
        assert dots["_softmax"] == scores["_softmax"] == 2


def test_resolve_remat():
    assert resolve_remat("auto", 1) == "full"
    assert resolve_remat("auto", 2) == "none"
    for r in POLICIES:
        assert resolve_remat(r, 0) == r
    with pytest.raises(ValueError):
        resolve_remat("offload", 0)
