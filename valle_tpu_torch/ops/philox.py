"""Dropout bytes from Philox4x32-10, the plain version of the kernels' own.

The JAX package draws its in-kernel dropout bits from the TPU's hardware
PRNG (``valle_tpu/ops/flash_mha.py:95-111``), which nothing else can
replay. The port's flash kernels (``csrc/flash_mha_fwd.cu``,
``csrc/flash_mha_bwd.cu``) instead compute a counter-based generator,
Philox4x32-10 (Salmon et al., SC'11), and this module computes the same
function in plain PyTorch over int64 tensors, so a kernel and its plain
version can be compared bit for bit with dropout on.

The byte of attention element (b, h, i, j) under a 64-bit ``seed`` is
byte ``j % 16`` (little-endian within each 32-bit word) of
``philox4x32_10(counter=(b*H + h, i, j // 16, 0), key=(seed & 0xffffffff,
seed >> 32))``. All products are split into 16-bit halves, so no int64
operation overflows.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64
    tensor x holding values in [0, 2**32)."""
    a = x * (m & 0xFFFF)                  # < 2**48
    b = x * (m >> 16)                     # < 2**48
    t = a + ((b & 0xFFFF) << 16)          # < 2**49
    return (b >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 counter words (broadcastable tensors
    of values in [0, 2**32)) under the key (k0, k1). Returns the four
    32-bit output words as int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int):
    """The Philox key words of a 64-bit seed."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed & _MASK32, seed >> 32


def dropout_bytes(seed: int, B: int, H: int, S: int, T: int,
                  device=None) -> torch.Tensor:
    """(B, H, S, T) uint8 bytes, element (b, h, i, j) as the module doc
    defines it."""
    k0, k1 = seed_key(seed)
    n16 = (T + 15) // 16
    bh = torch.arange(B * H, dtype=torch.int64, device=device)[:, None, None]
    i = torch.arange(S, dtype=torch.int64, device=device)[None, :, None]
    j16 = torch.arange(n16, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(bh, i, j16, zero, k0, k1)     # 4 x (BH, S, n16)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    per_word = [(w.expand(B * H, S, n16)[..., None] >> shifts) & 0xFF
                for w in words]                        # 4 x (BH, S, n16, 4)
    out = torch.stack(per_word, dim=-2).reshape(B * H, S, n16 * 16)
    return out[..., :T].to(torch.uint8).reshape(B, H, S, T)


def fold_seed(seed: int, i: int) -> int:
    """A 64-bit seed derived from (seed, i) by splitmix64: the port's
    counterpart of ``jax.random.fold_in`` for its integer seeds."""
    z = (int(seed) + (int(i) + 1) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return z ^ (z >> 31)


def keep_threshold(rate: float) -> int:
    """JAX's 8-bit keep rule: keep iff byte >= round(rate * 256)."""
    return int(round(rate * 256.0)) if rate > 0.0 else 0


def keep_scale(thresh: int) -> float:
    """Rescale by the quantized keep probability, 1 / (1 - thresh/256)."""
    return 1.0 / (1.0 - thresh / 256.0)
