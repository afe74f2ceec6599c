"""JAX parameter trees (as numpy nested dicts) -> the port's state dicts.

Pure numpy. ``valle_state_dict_from_jax`` gives, key for key and value
for value, what ``valle_tpu/utils/checkpoint.py:189
export_torch_state_dict`` gives: VALL-E or VALL-F (``multihead_attn``,
``norm3``), pre- or post-norm (no final norm), with or without the
prenets and their BatchNorm statistics;
``transformer_tts_state_dict_from_jax`` maps the Transformer TTS (both
``scaling_xformers`` settings); ``encodec_state_dict_from_jax`` maps the
encoder, decoder and quantizer of ``valle_tpu/codec/model.py:56
init_encodec`` to the encodec package's names (weight norm already
folded). ``load_numpy_state_dict`` loads any of them with
``strict=True``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def valle_state_dict_from_jax(params, cfg, state=None
                              ) -> Dict[str, np.ndarray]:
    """params: the JAX ``init_valle`` tree with numpy leaves; cfg: a
    ``ValleConfig`` of either package (same fields); state: JAX's
    ``state`` (the prenets' BatchNorm statistics; fresh ones where
    None)."""
    Q, V = cfg.num_quantizers, cfg.num_audio_tokens
    vallf = cfg.model_name == "vallf"
    sd: Dict[str, np.ndarray] = {}

    def put_attn(prefix, at, i):
        sd[f"{prefix}.in_proj_weight"] = _f32(at["in_w"])[i].T
        sd[f"{prefix}.in_proj_bias"] = _f32(at["in_b"])[i]
        sd[f"{prefix}.out_proj.weight"] = _f32(at["out_w"])[i].T
        sd[f"{prefix}.out_proj.bias"] = _f32(at["out_b"])[i]

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
            ff = layers["ffn"]
            put_attn(f"{p}.self_attn", layers["self_attn"], i)
            if vallf:
                put_attn(f"{p}.multihead_attn", layers["cross_attn"], i)
            sd[f"{p}.linear1.weight"] = _f32(ff["lin1"]["w"])[i].T
            sd[f"{p}.linear1.bias"] = _f32(ff["lin1"]["b"])[i]
            sd[f"{p}.linear2.weight"] = _f32(ff["lin2"]["w"])[i].T
            sd[f"{p}.linear2.bias"] = _f32(ff["lin2"]["b"])[i]
            for nm in ("norm1", "norm2") + (("norm3",) if vallf else ()):
                put_norm(f"{p}.{nm}", _index_tree(layers[nm], i))
        if "final_norm" in dec:
            put_norm(f"{prefix}.norm", dec["final_norm"])

    def put_prenets(branch):
        tp = params[branch].get("text_prenet")
        if tp is None:
            return
        ts = ((state or {}).get(branch) or {}).get("text_prenet") or {}
        _put_text_prenet(sd, f"{branch}_text_prenet", tp, ts)
        _put_audio_prenet(sd, f"{branch}_audio_prenet",
                          params[branch]["audio_prenet"])

    ar = params["ar"]
    sd["ar_text_embedding.word_embeddings.weight"] = _f32(
        ar["text_emb"]["weight"])
    sd["ar_audio_embedding.word_embeddings.weight"] = _f32(
        ar["audio_emb"]["weight"])
    sd["ar_text_position.alpha"] = _f32(ar["text_pe"]["alpha"]).reshape(1)
    sd["ar_audio_position.alpha"] = _f32(ar["audio_pe"]["alpha"]).reshape(1)
    put_stack("ar_decoder", ar["decoder"])
    sd["ar_predict_layer.weight"] = _f32(ar["predict"]["w"]).T
    put_prenets("ar")

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
        put_prenets("nar")
    # (ascontiguousarray would make the 0-d counters 1-d)
    return {k: np.array(v, order="C") for k, v in sd.items()}


def _put_text_prenet(sd, prefix: str, tp, ts) -> None:
    """JAX ``init_text_prenet`` params ``tp`` and statistics ``ts`` (fresh
    where missing) -> the reference's Sequential indices under
    ``prefix``."""
    for i, (ci, bi) in enumerate(((1, 2), (5, 6), (9, 10))):
        c, b = f"{prefix}.{ci}", f"{prefix}.{bi}"
        # ours (k, in, out) -> torch conv1d (out, in, k)
        sd[f"{c}.weight"] = np.transpose(_f32(tp[f"conv{i}"]["w"]),
                                         (2, 1, 0))
        sd[f"{c}.bias"] = _f32(tp[f"conv{i}"]["b"])
        scale = _f32(tp[f"bn{i}"]["scale"])
        sd[f"{b}.weight"] = scale
        sd[f"{b}.bias"] = _f32(tp[f"bn{i}"]["bias"])
        st = ts.get(f"bn{i}", {})
        sd[f"{b}.running_mean"] = _f32(st.get("mean", np.zeros_like(scale)))
        sd[f"{b}.running_var"] = _f32(st.get("var", np.ones_like(scale)))
        sd[f"{b}.num_batches_tracked"] = np.asarray(0, np.int64)
    sd[f"{prefix}.14.weight"] = _f32(tp["out"]["w"]).T
    sd[f"{prefix}.14.bias"] = _f32(tp["out"]["b"])


def _put_audio_prenet(sd, prefix: str, ap) -> None:
    for i, li in enumerate((0, 3, 6)):
        sd[f"{prefix}.{li}.weight"] = _f32(ap[f"lin{i}"]["w"]).T
        sd[f"{prefix}.{li}.bias"] = _f32(ap[f"lin{i}"]["b"])


def transformer_tts_state_dict_from_jax(params, cfg, state=None
                                        ) -> Dict[str, np.ndarray]:
    """params: the JAX ``init_transformer_tts`` tree with numpy leaves;
    cfg: a ``TransformerTtsConfig`` of either package; state: JAX's
    ``state`` (the encoder prenet's BatchNorm statistics; fresh ones where
    None). Returns the port's ``models/transformer.py`` state dict, whose
    names are the upstream reference's (``text_embedding``,
    ``encoder_prenet``, ``decoder_prenet``, ``encoder_position``,
    ``decoder_position``, ``encoder`` / ``decoder`` with PyTorch's
    ``nn.Transformer*`` layer names, ``predict_layer``, ``stop_layer``); a
    BalancedBasicNorm's JAX ``norm.log_eps`` is ``norm.eps``, an
    IdentityNorm (an empty JAX dict) has no entry. The JAX package's own
    exporter (``utils/checkpoint.py export_torch_state_dict``) has no
    Transformer branch."""
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix, p, i=None):
        w, b = _f32(p["w"]), p.get("b")
        sd[f"{prefix}.weight"] = (w if i is None else w[i]).T
        if b is not None:
            sd[f"{prefix}.bias"] = _f32(b) if i is None else _f32(b)[i]

    def put_norm(prefix, n, i=None):
        if not n:                                   # IdentityNorm
            return
        if "norm" in n:                             # BalancedBasicNorm
            le = _f32(n["norm"]["log_eps"])
            sd[f"{prefix}.norm.eps"] = le if i is None else le[i]
        else:
            for src, dst in (("scale", "weight"), ("bias", "bias")):
                v = _f32(n[src])
                sd[f"{prefix}.{dst}"] = v if i is None else v[i]

    def put_stack(prefix, stack, decoder):
        layers = stack["layers"]
        for i in range(_f32(layers["self_attn"]["in_w"]).shape[0]):
            p = f"{prefix}.layers.{i}"
            attns = [("self_attn", "self_attn")] + (
                [("multihead_attn", "cross_attn")] if decoder else [])
            for dst, src in attns:
                at = layers[src]
                sd[f"{p}.{dst}.in_proj_weight"] = _f32(at["in_w"])[i].T
                sd[f"{p}.{dst}.in_proj_bias"] = _f32(at["in_b"])[i]
                sd[f"{p}.{dst}.out_proj.weight"] = _f32(at["out_w"])[i].T
                sd[f"{p}.{dst}.out_proj.bias"] = _f32(at["out_b"])[i]
            put_linear(f"{p}.linear1", layers["ffn"]["lin1"], i)
            put_linear(f"{p}.linear2", layers["ffn"]["lin2"], i)
            for nm in ("norm1", "norm2") + (("norm3",) if decoder else ()):
                put_norm(f"{p}.{nm}", layers[nm], i)
        if "final_norm" in stack:
            put_norm(f"{prefix}.norm", stack["final_norm"])

    sd["text_embedding.word_embeddings.weight"] = _f32(
        params["text_emb"]["weight"])
    if cfg.add_prenet:
        _put_text_prenet(sd, "encoder_prenet", params["encoder_prenet"],
                         (state or {}).get("encoder_prenet") or {})
        _put_audio_prenet(sd, "decoder_prenet", params["decoder_prenet"])
    else:
        put_linear("decoder_prenet", params["decoder_prenet"])
    sd["encoder_position.alpha"] = np.ones((1,), np.float32)
    sd["decoder_position.alpha"] = np.ones((1,), np.float32)
    put_stack("encoder", params["encoder"], False)
    put_stack("decoder", params["decoder"], True)
    put_linear("predict_layer", params["predict"])
    put_linear("stop_layer", params["stop"])
    return {k: np.array(v, order="C") for k, v in sd.items()}


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
