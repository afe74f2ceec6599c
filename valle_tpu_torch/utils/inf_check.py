"""Non-finite diagnostics for a failed training step.

Mirror of ``valle_tpu/utils/inf_check.py``, written with PyTorch instead
of ``checkify``. The reference registers forward and backward hooks on
every ``nn.Module`` and logs the first module whose output holds inf or
nan (icefall's ``register_inf_check_hooks``, reference
``valle/bin/trainer.py:177-180``). The port's modules hold parameters
and are applied by functions (``modules/transformer.py``), so a forward
hook would never fire. Instead ``first_nan_location`` watches every
PyTorch call of the forward (a ``TorchFunctionMode``) and names the first
call whose output holds nan (infinities are legitimate there: masks are
-inf), with the module that owns the parameters it read (or the last
module whose parameters were read); the backward runs under
``torch.autograd.detect_anomaly``, which names the first backward
function that returned nan.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch
from torch import nn
from torch.overrides import TorchFunctionMode


def nonfinite_names(named_tensors: Iterable[Tuple[str, torch.Tensor]]
                    ) -> List[str]:
    """Names of the floating tensors holding inf or nan, each checked in
    its own dtype (a float64 value beyond float32's range stays finite);
    integer tensors are finite."""
    return [name for name, t in named_tensors
            if t is not None and t.is_floating_point()
            and not bool(torch.isfinite(t).all())]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _finite(t: torch.Tensor) -> bool:
    return not t.is_floating_point() or bool(torch.isfinite(t).all())


def _no_nan(t: torch.Tensor) -> bool:
    return not t.is_floating_point() or not bool(torch.isnan(t).any())


class _FirstNaN(TorchFunctionMode):
    """Records the first PyTorch call whose output holds nan."""

    def __init__(self, model: nn.Module):
        super().__init__()
        # a parameter (or a view of one) -> (owning module, its name)
        self.owner = {}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                self.owner.setdefault(
                    id(p), (mname, f"{mname}.{pname}" if mname else pname))
        self.module = "(no parameter read yet)"
        self.found: Optional[str] = None

    def _param_of(self, t: torch.Tensor):
        return self.owner.get(id(t)) or (
            self.owner.get(id(t._base)) if t._base is not None else None)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.found is not None:
            return out
        inputs = list(_tensors((args, kwargs or {})))
        params = [self._param_of(t) for t in inputs]
        params = [p for p in params if p is not None]
        if params:
            self.module = params[0][0]
        if not all(_no_nan(t) for t in _tensors(out)):
            name = getattr(func, "__name__", str(func))
            bad_in = [p[1] for p in params
                      if not _finite(self._tensor_of(inputs, p))]
            cause = (f"non-finite parameter {bad_in}" if bad_in else
                     "its inputs are finite" if all(map(_finite, inputs))
                     else "a non-finite input")
            self.found = (f"forward: {name} in module "
                          f"{self.module or '(root)'} ({cause})")
        return out

    def _tensor_of(self, inputs, param):
        for t in inputs:
            if self._param_of(t) == param:
                return t
        raise KeyError(param)


def first_nan_location(loss_fn: Callable, model: nn.Module,
                       *args) -> Optional[str]:
    """Run ``loss_fn(model, *args)`` and its backward; returns a message
    naming the first call whose output holds nan (the forward's, else the
    backward's), or None if no nan was produced."""
    mode = _FirstNaN(model)
    with mode:
        loss = loss_fn(model, *args)
    if mode.found is not None:
        return mode.found
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            loss.backward()
    except RuntimeError as e:
        return f"backward: {str(e).splitlines()[0]}"
    finally:
        model.zero_grad(set_to_none=True)
    return None


def diagnose_nonfinite(loss_fn: Callable, model: nn.Module, *args) -> str:
    """Full report for a non-finite training step.

    ``loss_fn(model, *args) -> scalar loss`` should reproduce the failing
    computation (same weights, batch and random draws). Returns a
    multi-line report: non-finite parameters, non-finite gradients, and
    the first call that produced a non-finite value."""
    lines = []
    bad_params = nonfinite_names(model.named_parameters())
    if bad_params:
        lines.append(f"non-finite PARAM leaves: {bad_params}")
    try:
        model.zero_grad(set_to_none=True)
        loss_fn(model, *args).backward()
        bad_grads = nonfinite_names((n, p.grad)
                                    for n, p in model.named_parameters())
        if bad_grads:
            lines.append(f"non-finite GRAD leaves: {bad_grads}")
    except RuntimeError as e:  # diagnosis must never mask the failure
        lines.append(f"(grad recomputation failed: {e})")
    finally:
        model.zero_grad(set_to_none=True)
    try:
        loc = first_nan_location(loss_fn, model, *args)
        if loc:
            lines.append(f"first NaN op: {loc}")
    except RuntimeError as e:
        lines.append(f"(the traced pass failed: {e})")
    return "\n".join(lines) if lines else "no non-finite values reproduced"
