"""JAX parameter trees (as numpy nested dicts) -> the port's state dicts.

Pure numpy. ``valle_state_dict_from_jax`` gives, key for key and value
for value, what ``valle_tpu/utils/checkpoint.py:189
export_torch_state_dict`` gives for a decoder-only VALL-E without
prenets; ``encodec_state_dict_from_jax`` maps the encoder, decoder and
quantizer of ``valle_tpu/codec/model.py:56 init_encodec`` to the encodec
package's names (weight norm already folded). ``load_numpy_state_dict`` loads
either with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def valle_state_dict_from_jax(params, cfg) -> Dict[str, np.ndarray]:
    """params: the JAX ``init_valle`` tree with numpy leaves; cfg: a
    ``ValleConfig`` of either package (same fields)."""
    if cfg.model_name != "valle" or cfg.add_prenet:
        raise NotImplementedError(
            "VALL-F and prenets are not ported yet (ROADMAP A13/A14)")
    Q, V = cfg.num_quantizers, cfg.num_audio_tokens
    sd: Dict[str, np.ndarray] = {}

    def put_norm(prefix, n):
        if "proj" in n:  # AdaptiveLayerNorm
            sd[f"{prefix}.project_layer.weight"] = _f32(n["proj"]["w"]).T
            sd[f"{prefix}.project_layer.bias"] = _f32(n["proj"]["b"])
            sd[f"{prefix}.norm.weight"] = _f32(n["norm"]["scale"])
            sd[f"{prefix}.norm.bias"] = _f32(n["norm"]["bias"])
        else:
            sd[f"{prefix}.weight"] = _f32(n["scale"])
            sd[f"{prefix}.bias"] = _f32(n["bias"])

    def put_stack(prefix, dec):
        layers = dec["layers"]
        n_layers = _f32(layers["self_attn"]["in_w"]).shape[0]
        for i in range(n_layers):
            p = f"{prefix}.layers.{i}"
            at, ff = layers["self_attn"], layers["ffn"]
            sd[f"{p}.self_attn.in_proj_weight"] = _f32(at["in_w"])[i].T
            sd[f"{p}.self_attn.in_proj_bias"] = _f32(at["in_b"])[i]
            sd[f"{p}.self_attn.out_proj.weight"] = _f32(at["out_w"])[i].T
            sd[f"{p}.self_attn.out_proj.bias"] = _f32(at["out_b"])[i]
            sd[f"{p}.linear1.weight"] = _f32(ff["lin1"]["w"])[i].T
            sd[f"{p}.linear1.bias"] = _f32(ff["lin1"]["b"])[i]
            sd[f"{p}.linear2.weight"] = _f32(ff["lin2"]["w"])[i].T
            sd[f"{p}.linear2.bias"] = _f32(ff["lin2"]["b"])[i]
            for nm in ("norm1", "norm2"):
                put_norm(f"{p}.{nm}", _index_tree(layers[nm], i))
        if "final_norm" in dec:
            put_norm(f"{prefix}.norm", dec["final_norm"])

    ar = params["ar"]
    sd["ar_text_embedding.word_embeddings.weight"] = _f32(
        ar["text_emb"]["weight"])
    sd["ar_audio_embedding.word_embeddings.weight"] = _f32(
        ar["audio_emb"]["weight"])
    sd["ar_text_position.alpha"] = _f32(ar["text_pe"]["alpha"]).reshape(1)
    sd["ar_audio_position.alpha"] = _f32(ar["audio_pe"]["alpha"]).reshape(1)
    put_stack("ar_decoder", ar["decoder"])
    sd["ar_predict_layer.weight"] = _f32(ar["predict"]["w"]).T

    if Q > 1:
        nar = params["nar"]
        sd["nar_text_embedding.word_embeddings.weight"] = _f32(
            nar["text_emb"]["weight"])
        embs = _f32(nar["audio_embs"]["weight"])          # (Q, V+1, nd)
        sd["nar_audio_embeddings.0.word_embeddings.weight"] = embs[0]
        for j in range(1, Q):
            sd[f"nar_audio_embeddings.{j}.word_embeddings.weight"] = (
                embs[j][:V])
        sd["nar_text_position.alpha"] = np.ones((1,), np.float32)
        sd["nar_audio_position.alpha"] = np.ones((1,), np.float32)
        put_stack("nar_decoder", nar["decoder"])
        if cfg.share_embedding:
            for j in range(Q - 2):
                sd[f"nar_predict_layers.{j}.weight"] = embs[j + 2][:V]
            sd[f"nar_predict_layers.{Q - 2}.weight"] = _f32(
                nar["predict_last"]["w"]).T
        else:
            pw = _f32(nar["predict"]["w"])                  # (Q-1, nd, V)
            for j in range(Q - 1):
                sd[f"nar_predict_layers.{j}.weight"] = pw[j].T
        stage = _f32(nar["stage_embs"]["weight"])           # (Q-1, nd)
        for j in range(Q - 1):
            sd[f"nar_stage_embeddings.{j}.word_embeddings.weight"] = (
                stage[j][None, :])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return _f32(tree)[i]


def encodec_state_dict_from_jax(params, num_ratios: int = 4
                                ) -> Dict[str, np.ndarray]:
    """Encoder, decoder and quantizer of the JAX EnCodec tree -> encodec
    names."""
    enc, dec = params["encoder"], params["decoder"]
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, p):  # ours (k, in, out) -> torch conv1d (out, in, k)
        sd[f"{prefix}.conv.conv.weight"] = np.transpose(_f32(p["w"]),
                                                        (2, 1, 0))
        sd[f"{prefix}.conv.conv.bias"] = _f32(p["b"])

    def convtr(prefix, p):  # ours (k, out, in) -> torch (in, out, k)
        sd[f"{prefix}.convtr.convtr.weight"] = np.transpose(_f32(p["w"]),
                                                            (2, 1, 0))
        sd[f"{prefix}.convtr.convtr.bias"] = _f32(p["b"])

    def resblock(prefix, p):
        conv(f"{prefix}.block.1", p["conv1"])
        conv(f"{prefix}.block.3", p["conv2"])
        conv(f"{prefix}.shortcut", p["shortcut"])

    def lstm(prefix, p):
        layers = p["layers"]
        for i in range(_f32(layers["w_ih"]).shape[0]):
            sd[f"{prefix}.lstm.weight_ih_l{i}"] = _f32(layers["w_ih"])[i].T
            sd[f"{prefix}.lstm.weight_hh_l{i}"] = _f32(layers["w_hh"])[i].T
            sd[f"{prefix}.lstm.bias_ih_l{i}"] = _f32(layers["b_ih"])[i]
            sd[f"{prefix}.lstm.bias_hh_l{i}"] = _f32(layers["b_hh"])[i]

    # encoder: conv 0; (resblock, ELU, strided conv) per ratio; LSTM; ELU;
    # final conv
    conv("encoder.model.0", enc["init_conv"])
    idx = 1
    for i in range(num_ratios):
        resblock(f"encoder.model.{idx}", enc[f"res{i}"])
        conv(f"encoder.model.{idx + 2}", enc[f"down{i}"])
        idx += 3
    lstm(f"encoder.model.{idx}", enc["lstm"])
    conv(f"encoder.model.{idx + 2}", enc["final_conv"])

    conv("decoder.model.0", dec["init_conv"])
    lstm("decoder.model.1", dec["lstm"])
    idx = 3
    for i in range(num_ratios):
        convtr(f"decoder.model.{idx}", dec[f"up{i}"])
        resblock(f"decoder.model.{idx + 1}", dec[f"res{i}"])
        idx += 3
    conv(f"decoder.model.{idx}", dec["final_conv"])
    embed = _f32(params["quantizer"]["embed"])
    for q in range(embed.shape[0]):
        sd[f"quantizer.vq.layers.{q}._codebook.embed"] = embed[q]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def load_numpy_state_dict(module: torch.nn.Module,
                          sd: Dict[str, np.ndarray]) -> None:
    """``load_state_dict(strict=True)`` from numpy arrays."""
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
