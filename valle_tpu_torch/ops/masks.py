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


def _packed_visible(text_seg: torch.Tensor, audio_seg: torch.Tensor,
                    structure: torch.Tensor) -> torch.Tensor:
    """(B, 1, St, St) additive bias of a packed row: a query sees a key of
    its own segment where ``structure`` (St, St) allows, and always its
    own position (padded query rows stay finite; the loss drops them)."""
    seg = torch.cat([text_seg, audio_seg], dim=1)
    St = seg.shape[1]
    same_seg = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0)
    eye = torch.eye(St, dtype=torch.bool, device=seg.device)
    visible = (same_seg & structure[None]) | eye[None]
    bias = torch.zeros(visible.shape, dtype=torch.float32, device=seg.device)
    bias.masked_fill_(~visible, NEG_INF)
    return bias[:, None]


def packed_ar_attn_bias(text_seg: torch.Tensor, audio_seg: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """AR mask of sequence-packed ``[text; audio]`` rows: ``text_seg``
    (B, S) and ``audio_seg`` (B, T) hold each position's segment id (-1 =
    padding). Within a segment the structure of :func:`ar_xy_attn_bias`
    (text bidirectional, audio sees its text and causally its audio);
    nothing crosses segments; the diagonal is always visible. Returns
    (B, 1, S+T, S+T)."""
    S = text_seg.shape[1]
    pos = torch.arange(S + audio_seg.shape[1], device=text_seg.device)
    is_y = pos >= S
    q, k = pos[:, None], pos[None, :]
    structure = ((~is_y[:, None]) & (~is_y[None, :])) | (
        is_y[:, None] & ((~is_y[None, :]) | (k <= q)))
    return _packed_visible(text_seg, audio_seg, structure).to(dtype)


def packed_nar_attn_bias(text_seg: torch.Tensor, audio_seg: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """NAR mask of sequence-packed rows: every position sees every text
    and audio position of its own segment, in both directions, and its
    own position. Returns (B, 1, S+T, S+T)."""
    St = text_seg.shape[1] + audio_seg.shape[1]
    structure = torch.ones(St, St, dtype=torch.bool, device=text_seg.device)
    return _packed_visible(text_seg, audio_seg, structure).to(dtype)


def _packed_segments(text_seg: torch.Tensor, audio_seg: torch.Tensor):
    """(seg, qseg, kseg) int32 of a packed row: padding takes qseg -1 and
    kseg -2, so a padded position sees only its own diagonal."""
    seg = torch.cat([text_seg, audio_seg], dim=1).to(torch.int32)
    qseg = torch.where(seg >= 0, seg, -1).to(torch.int32)
    kseg = torch.where(seg >= 0, seg, -2).to(torch.int32)
    return seg, qseg, kseg


def flash_codes_packed_ar(text_seg: torch.Tensor, audio_seg: torch.Tensor):
    """Code and segment twin of :func:`packed_ar_attn_bias`: text code 0,
    audio position p (of the whole row) code p + 1. Returns int32 (qcode,
    kcode, qseg, kseg), each (B, S+T); the kernel runs with
    ``add_diag=True``."""
    S = text_seg.shape[1]
    seg, qseg, kseg = _packed_segments(text_seg, audio_seg)
    pos = torch.arange(seg.shape[1], dtype=torch.int32, device=seg.device)
    base = torch.where(pos < S, 0, pos + 1).to(torch.int32)
    qcode = base.expand(seg.shape).contiguous()
    return qcode, qcode, qseg, kseg


def flash_codes_packed_nar(text_seg: torch.Tensor, audio_seg: torch.Tensor):
    """Code and segment twin of :func:`packed_nar_attn_bias` (codes all 0;
    ``add_diag=True``)."""
    seg, qseg, kseg = _packed_segments(text_seg, audio_seg)
    qcode = torch.zeros(seg.shape, dtype=torch.int32, device=seg.device)
    return qcode, qcode, qseg, kseg


def key_padding_bias(lens: torch.Tensor, T: int,
                     dtype=torch.float32) -> torch.Tensor:
    """(B, 1, 1, T) bias masking padded keys."""
    kk = torch.arange(T, device=lens.device)[None, :]
    bias = torch.zeros(lens.shape[0], T, dtype=dtype, device=lens.device)
    bias.masked_fill_(kk >= lens[:, None], NEG_INF)
    return bias[:, None, None, :]


def causal_bias(T: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(1, 1, T, T) inclusive-causal bias: query q sees keys k <= q."""
    kk = torch.arange(T, device=device)
    bias = torch.zeros(T, T, dtype=dtype, device=device)
    bias.masked_fill_(kk[None, :] > kk[:, None], NEG_INF)
    return bias[None, None]
