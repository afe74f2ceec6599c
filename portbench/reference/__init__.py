"""Plain references, one module a model (``<model_name>.py``) and one for
the codec. A model's module gives ``parameter_shapes(cfg)``,
``tied_heads(cfg)`` and the class ``Model(cfg, sd, prec)`` with
``ar_logits`` and ``nar_logits``; the harness finds it by the
configuration's ``model.model_name``."""

import importlib


def model_reference(model_name: str):
    """The reference module of ``model_name``."""
    return importlib.import_module(f"portbench.reference.{model_name}")
