"""Model factory, CLI arguments and the resolvers of the model options
(mirror of ``valle_tpu/models/__init__.py``: ``add_model_arguments``,
``get_model``, ``resolve_score_bf16``, ``resolve_attn_impl``,
``resolve_remat``), and ``load_model`` for reference-format ``.pt``
checkpoints (``valle_tpu/bin/infer.py:76``).

The JAX package's thresholds were measured on a TPU; where the port keeps
them, they wait to be measured again on the H100.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..utils import str2bool


def add_model_arguments(parser: argparse.ArgumentParser) -> None:
    """The JAX package's model flags, names and defaults unchanged."""
    parser.add_argument("--model-name", type=str, default="VALL-E",
                        help="VALL-E | VALL-F | Transformer.")
    parser.add_argument("--decoder-dim", type=int, default=1024,
                        help="Embedding dimension in the decoder model.")
    parser.add_argument("--nhead", type=int, default=16,
                        help="Number of attention heads.")
    parser.add_argument("--num-decoder-layers", type=int, default=12,
                        help="Number of decoder layers.")
    parser.add_argument("--scale-factor", type=float, default=1.0,
                        help="Model scale factor which will be assigned "
                             "different meanings in different models.")
    parser.add_argument("--norm-first", type=str2bool, default=True,
                        help="Pre or Post Normalization.")
    parser.add_argument("--add-prenet", type=str2bool, default=False,
                        help="Whether to add PreNet after Inputs.")
    parser.add_argument("--prefix-mode", type=int, default=0,
                        help="The mode for how to prefix VALL-E NAR Decoder, "
                             "0: no prefix, 1: 0 to random, 2: random to "
                             "random, 4: chunk of pre or post utterance.")
    parser.add_argument("--share-embedding", type=str2bool, default=True,
                        help="Share the parameters of the output projection "
                             "layer with the parameters of the acoustic "
                             "embedding.")
    parser.add_argument("--prepend-bos", type=str2bool, default=False,
                        help="Whether to prepend <BOS> to the acoustic "
                             "tokens -> AR Decoder inputs.")
    parser.add_argument("--num-quantizers", type=int, default=8,
                        help="Number of Audio/Semantic quantization layers.")
    parser.add_argument("--scaling-xformers", type=str2bool, default=False,
                        help="Apply the scaling-transformer variant "
                             "(Transformer model only).")
    parser.add_argument("--attn-score-bf16", type=str, default="auto",
                        help="bf16 score materialization in training "
                             "attention: auto | on | off (inert at fp32).")
    parser.add_argument("--attn-impl", type=str, default="auto",
                        choices=("auto", "einsum", "flash"),
                        help="Training-attention implementation: einsum or "
                             "flash (the hand-written flash kernels). "
                             "'auto' = flash on CUDA at head dims 64/128.")
    parser.add_argument("--remat", type=str, default="auto",
                        help="Training rematerialization policy: auto | "
                             "full | dots | scores | none ('auto': none "
                             "for --train-stage 2, full otherwise).")


def get_model(params, *, device="cuda"):
    """A ``models.valle.VALLE`` on ``device`` from an (argparse-derived)
    params bag, its parameters as PyTorch creates them (load weights
    next); ``device`` also resolves ``--attn-impl auto``: VALL-E or VALL-F,
    pre- or post-norm (``--norm-first``), with or without prenets
    (``--add-prenet``). The Transformer TTS model is not ported (ROADMAP
    A14)."""
    from .valle import VALLE, ValleConfig

    name = params.model_name.lower()
    if name == "transformer":
        raise NotImplementedError(
            "the Transformer TTS model is not ported yet (ROADMAP A14)")
    if name not in ("vall-e", "valle", "vall-f", "vallf"):
        raise ValueError(f"unknown model name {params.model_name!r}")
    model_name = "vallf" if "f" in name.replace("vall", "") else "valle"
    cfg = ValleConfig(
        remat=resolve_remat(getattr(params, "remat", "auto"),
                            getattr(params, "train_stage", 0)),
        attn_score_bf16=resolve_score_bf16(
            getattr(params, "attn_score_bf16", "auto")),
        attn_impl=resolve_attn_impl(
            getattr(params, "attn_impl", "auto"), model_name, device,
            head_dim=params.decoder_dim // params.nhead),
        model_name=model_name,
        d_model=params.decoder_dim,
        nhead=params.nhead,
        num_layers=params.num_decoder_layers,
        norm_first=params.norm_first,
        add_prenet=params.add_prenet,
        prefix_mode=params.prefix_mode,
        share_embedding=params.share_embedding,
        nar_scale_factor=params.scale_factor,
        prepend_bos=params.prepend_bos,
        num_quantizers=params.num_quantizers,
    )
    return VALLE(cfg).to(device)


def load_model(checkpoint: str, args=None, *, device="cuda"):
    """Rebuild a ``VALLE`` from a reference-format ``.pt`` checkpoint.

    Hyperparameters stored in the checkpoint come first; what it does not
    record falls back to the model flags of ``args``, then to the flags'
    defaults (``model_name`` VALL-E, ``norm_first`` true, ``add_prenet``
    false: JAX ``bin/infer.py``'s), and ``get_model`` builds the model.
    The weights (under ``"model"``, or the file's tensors) load with
    ``strict=True``: the port uses the reference's names, the prenets'
    BatchNorm statistics included. Returns (model on ``device`` in eval
    mode, the symbol-table path the checkpoint names or None).
    """
    p = Path(checkpoint)
    if p.is_dir():
        raise NotImplementedError(
            f"{checkpoint!r} is a directory: orbax checkpoints need jax, "
            "which the port does not import; the port's trainer "
            "(valle_tpu_torch.bin.trainer) writes reference-format .pt "
            "files, which load here")
    if not (p.is_file() and p.suffix in (".pt", ".pth", ".bin")):
        raise FileNotFoundError(f"no .pt/.pth/.bin checkpoint at "
                                f"{checkpoint!r}")
    raw = torch.load(str(p), map_location="cpu", weights_only=False)
    ckpt = raw if isinstance(raw, dict) else {}
    parser = argparse.ArgumentParser()
    add_model_arguments(parser)
    params = vars(parser.parse_args([]))
    for src in (vars(args) if args is not None else {}, ckpt):
        params.update((k, src[k]) for k in params if k in src)
    model = get_model(argparse.Namespace(**params), device=device)
    sd = ckpt.get("model", ckpt)
    sd = {k: torch.as_tensor(v) for k, v in sd.items()
          if isinstance(v, (torch.Tensor, np.ndarray))}
    model.load_state_dict(sd, strict=True)
    return model.eval(), ckpt.get("text_tokens")


def resolve_score_bf16(mode: str) -> bool:
    """``--attn-score-bf16``: "auto" and "on" store attention scores in
    bf16 when the compute dtype is bf16 (inert at fp32); "off" never."""
    if mode in ("auto", "on", "1", "true"):
        return True
    if mode in ("off", "0", "false"):
        return False
    raise ValueError(f"unknown attn-score-bf16 mode {mode!r}")


def resolve_attn_impl(mode: str, model_name: str = "valle", device="cuda",
                      *, head_dim: int) -> str:
    """``--attn-impl``: "auto" is the flash kernels on CUDA where they take
    the model's head dim (``d_model // nhead``; ``FLASH_HEAD_DIMS``), and
    the einsum path otherwise (on the CPU flash would run its plain
    version; einsum computes the same function). VALL-F has no flash path.
    An explicit "flash" at another head dim raises in the kernel's
    wrapper."""
    from ..ops.flash_mha import FLASH_HEAD_DIMS

    if model_name == "vallf":
        return "einsum"
    if mode == "auto":
        return ("flash" if torch.device(device).type == "cuda"
                and head_dim in FLASH_HEAD_DIMS else "einsum")
    if mode in ("einsum", "flash"):
        return mode
    raise ValueError(f"unknown attn-impl {mode!r}")


def resolve_remat(remat: str, train_stage: int) -> str:
    """``--remat``: "auto" is "none" for the NAR stage (train_stage 2) and
    "full" otherwise, the JAX package's per-stage picks (measured on a
    TPU; not yet on the H100). "full", "dots", "scores" and "none" pass
    through (``modules/transformer.py encoder_stack_apply`` says what
    each keeps)."""
    from ..modules.transformer import REMAT_MODES

    if remat == "auto":
        return "none" if train_stage == 2 else "full"
    if remat in REMAT_MODES:
        return remat
    raise ValueError(f"unknown remat policy {remat!r}")
