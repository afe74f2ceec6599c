"""The precision a reference computes its products in.

The reference runs in float32 with TF32 off. Its controls, the steps
below the precision a configuration states, round the operands of every
product before an float32 product:

- "fp32": no rounding (the reference);
- "tf32": each operand to 10 mantissa bits, round to nearest even, as
  TF32 tensor cores take their inputs (the control of a float32 stage
  that runs with TF32 off);
- "fp8": each operand to float8 e4m3, scaled per row (the last axis) to
  its largest magnitude over 448 (the control of a bfloat16 stage).
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "fp8")
_E4M3_MAX = 448.0


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to
    even), as bits: exact on every device."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded through float8 e4m3 with one scale a row."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


# the control of a stage served in a dtype: the nearest precision below
# it (float32 runs with TF32 off in the port)
BELOW = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}


def below(dtype: str) -> str:
    """The control's precision for a stage that a configuration serves in
    ``dtype``."""
    if dtype not in BELOW:
        raise ValueError(f"no control precision below {dtype!r} (have "
                         f"{sorted(BELOW)})")
    return BELOW[dtype]


class Precision:
    """Rounds product operands to one of ``PRECISIONS``."""

    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}: "
                             f"{name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return to_tf32(x)
        if self.name == "fp8":
            return to_fp8(x)
        return x.float()

    def linear(self, x, w, b=None):
        """x @ w^T + b, ``w`` in PyTorch's (out, in) layout."""
        y = self(x) @ self(w).T
        return y if b is None else y + b.float()

    def matmul(self, a, b):
        return self(a) @ self(b.transpose(-1, -2)).transpose(-1, -2)


def plain_matmuls():
    """Context for the reference's products: TF32 off in matmuls and in
    cuDNN, restored on exit."""
    return _NoTF32()


class _NoTF32:
    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev
        return False
