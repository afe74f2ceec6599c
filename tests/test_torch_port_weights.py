"""Port weights: JAX trees -> the port's state dicts (utils/convert.py)."""

import numpy as np
import pytest
import torch

import jax

from valle_tpu.codec.model import EncodecConfig as JaxEncodecConfig
from valle_tpu.codec.model import init_encodec
from valle_tpu.utils.checkpoint import export_torch_state_dict
from valle_tpu_torch.codec.model import EncodecModel
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.utils.convert import (encodec_state_dict_from_jax,
                                           load_numpy_state_dict,
                                           valle_state_dict_from_jax)

from torch_port_helpers import SMALL, make_pair


@pytest.mark.parametrize("share_embedding,prepend_bos",
                         [(True, False), (True, True), (False, False)])
def test_valle_state_dict_equals_export_and_round_trips(share_embedding,
                                                        prepend_bos):
    jcfg, params, model = make_pair(share_embedding=share_embedding,
                                    prepend_bos=prepend_bos)
    sd = valle_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jcfg)
    ref = export_torch_state_dict(params, jcfg)
    assert sd.keys() == ref.keys()
    for k in sd:
        assert sd[k].dtype == ref[k].dtype and np.array_equal(sd[k], ref[k]), k
    # make_pair loaded it with strict=True; the module gives it back bitwise
    back = {k: v.numpy() for k, v in model.state_dict().items()}
    assert back.keys() == sd.keys()
    for k in sd:
        assert np.array_equal(back[k], sd[k]), k


def test_nar_heads_are_tied_to_audio_embeddings():
    _, _, model = make_pair()
    Q = model.cfg.num_quantizers
    for j in range(Q - 2):
        assert (model.nar_predict_layers[j].weight
                is model.nar_audio_embeddings[j + 2].word_embeddings.weight)


def test_encodec_state_dict_loads_strict_and_round_trips():
    params = jax.tree_util.tree_map(
        np.asarray, init_encodec(jax.random.PRNGKey(0), JaxEncodecConfig()))
    sd = encodec_state_dict_from_jax(params)
    codec = EncodecModel()
    load_numpy_state_dict(codec, sd)
    back = codec.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        assert np.array_equal(back[k].numpy(), sd[k]), k


def test_seeded_init_is_reproducible():
    cfg = ValleConfig(**SMALL)
    a = VALLE(cfg, generator=torch.Generator().manual_seed(3))
    b = VALLE(cfg, generator=torch.Generator().manual_seed(3))
    c = VALLE(cfg, generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ar_decoder.layers.0.linear1.weight"],
                           sc["ar_decoder.layers.0.linear1.weight"])
    assert float(sa["ar_audio_position.alpha"]) == 1.0


@pytest.mark.parametrize("override", [{"add_prenet": True},
                                      {"model_name": "vallf"},
                                      {"norm_first": False}])
def test_unported_model_options_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP A1[34]"):
        VALLE(ValleConfig(**{**SMALL, **override}))
