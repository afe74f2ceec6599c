"""Attention masks as additive biases, and flash visibility codes.

Mirror of ``valle_tpu/ops/masks.py``. The additive biases use
``NEG_INF = -inf``; the flash codes use ``CODE_INVALID`` from
``ops/flash_mha.py``, whose kernel masks with the finite -1e30.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def ar_xy_attn_bias(x_lens: torch.Tensor, y_lens: torch.Tensor, x_len: int,
                    y_len: int, dtype=torch.float32) -> torch.Tensor:
    """Composite AR mask for ``[text; audio]``: text bidirectional, audio
    causal, audio sees all text, text sees no audio, padded keys masked.
    Returns (B, 1, S, S) with 0 at visible and -inf at masked positions."""
    dev = x_lens.device
    S = x_len + y_len
    pos = torch.arange(S, device=dev)
    is_y = pos >= x_len
    q, k = pos[:, None], pos[None, :]
    text_q_ok = (~is_y[:, None]) & (~is_y[None, :])
    audio_q_ok = is_y[:, None] & ((~is_y[None, :]) | (k <= q))
    visible = text_q_ok | audio_q_ok
    key_valid = _key_valid(x_lens, y_lens, x_len, S)
    mask = visible[None] & key_valid[:, None, :]
    bias = torch.zeros(mask.shape, dtype=dtype, device=dev)
    bias.masked_fill_(~mask, NEG_INF)
    return bias[:, None]


def _key_valid(x_lens, y_lens, x_len: int, S: int) -> torch.Tensor:
    kk = torch.arange(S, device=x_lens.device)[None, :]
    return torch.where(kk < x_len, kk < x_lens[:, None],
                       (kk - x_len) < y_lens[:, None])


def padding_attn_bias(x_lens: torch.Tensor, y_lens: torch.Tensor,
                      x_len: int, y_len: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Bidirectional (NAR) bias over ``[text; audio]``: only padded keys
    are masked. Shape (B, 1, 1, S)."""
    key_valid = _key_valid(x_lens, y_lens, x_len, x_len + y_len)
    bias = torch.zeros(key_valid.shape, dtype=dtype, device=x_lens.device)
    bias.masked_fill_(~key_valid, NEG_INF)
    return bias[:, None, None, :]


def flash_codes_ar_xy(x_lens: torch.Tensor, y_lens: torch.Tensor,
                      x_len: int, y_len: int):
    """Code-form twin of :func:`ar_xy_attn_bias`: text positions carry
    code 0, audio position t carries t + 1 (so ``kcode <= qcode`` is the
    causal rule), padded keys CODE_INVALID. Returns int32 (qcode, kcode),
    each (B, S)."""
    from .flash_mha import CODE_INVALID

    S = x_len + y_len
    pos = torch.arange(S, dtype=torch.int32, device=x_lens.device)
    base = torch.where(pos < x_len, 0, pos - x_len + 1).to(torch.int32)
    qcode = base.expand(x_lens.shape[0], S).contiguous()
    key_valid = _key_valid(x_lens, y_lens, x_len, S)
    kcode = torch.where(key_valid, base[None, :], CODE_INVALID)
    return qcode, kcode.to(torch.int32)


def flash_codes_padding(x_lens: torch.Tensor, y_lens: torch.Tensor,
                        x_len: int, y_len: int):
    """Code-form twin of :func:`padding_attn_bias` (NAR: padded keys
    only)."""
    return flash_codes_key_valid(
        _key_valid(x_lens, y_lens, x_len, x_len + y_len))


def flash_codes_key_valid(key_valid: torch.Tensor):
    """Codes from an explicit (B, T) key-validity mask: qcode 0 everywhere,
    kcode 0 for valid keys and CODE_INVALID for padded ones."""
    from .flash_mha import CODE_INVALID

    qcode = torch.zeros(key_valid.shape, dtype=torch.int32,
                        device=key_valid.device)
    kcode = torch.where(key_valid, 0, CODE_INVALID).to(torch.int32)
    return qcode, kcode


def key_padding_bias(lens: torch.Tensor, T: int,
                     dtype=torch.float32) -> torch.Tensor:
    """(B, 1, 1, T) bias masking padded keys."""
    kk = torch.arange(T, device=lens.device)[None, :]
    bias = torch.zeros(lens.shape[0], T, dtype=dtype, device=lens.device)
    bias.masked_fill_(kk >= lens[:, None], NEG_INF)
    return bias[:, None, None, :]
