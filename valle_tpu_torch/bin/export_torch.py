#!/usr/bin/env python3
"""Export a trainer checkpoint of the port as a reference-format ``.pt``
(the port's counterpart of ``valle_tpu/bin/export_torch.py``, which reads
orbax directories).

The port's trainer writes ``.pt`` files that also hold the optimizer,
the sampler, the averaged model and every run flag. The export keeps what
the reference's ``bin/infer.py`` reads: the ``"model"`` state dict and
the model's hyperparameter keys (``model_name``, ``decoder_dim``,
``nhead``, ``num_decoder_layers``, ...), plus ``text_tokens`` where the
checkpoint names one. The model is rebuilt and loaded with
``strict=True`` first (``models.load_model``), so a checkpoint that does
not load is refused; ``valle_tpu_torch.bin.infer`` (VALL-E, VALL-F) and
``models.load_model`` (every model) read the output. On the host; no
device.

Usage:
  python -m valle_tpu_torch.bin.export_torch <exp/epoch-N.pt> <out.pt>
"""

import sys


def export(checkpoint: str, out_path: str) -> int:
    """Write the export of ``checkpoint`` to ``out_path``; returns the
    number of tensors."""
    import torch

    from ..models import load_model
    from ..models.valle import VALLE

    model, text_tokens = load_model(checkpoint, device="cpu")
    cfg = model.cfg
    if isinstance(model, VALLE):
        hyper = {
            "model_name": "VALL-F" if cfg.model_name == "vallf" else "VALL-E",
            "prefix_mode": cfg.prefix_mode,
            "share_embedding": cfg.share_embedding,
            "scale_factor": cfg.nar_scale_factor,
            "prepend_bos": cfg.prepend_bos,
            "num_quantizers": cfg.num_quantizers}
    else:
        hyper = {"model_name": "Transformer",
                 "scaling_xformers": cfg.scaling_xformers}
    sd = model.state_dict()
    blob = {"model": sd, "decoder_dim": cfg.d_model, "nhead": cfg.nhead,
            "num_decoder_layers": cfg.num_layers,
            "norm_first": cfg.norm_first, "add_prenet": cfg.add_prenet,
            **hyper}
    if text_tokens is not None:
        blob["text_tokens"] = text_tokens
    torch.save(blob, out_path)
    return len(sd)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    n = export(*argv)
    print(f"wrote {argv[1]} ({n} tensors)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
