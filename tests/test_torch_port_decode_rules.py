"""Host-side launch rules of the decode kernels: the rows a B12
thread-block cluster holds, and the operands B8's and B3's launchers
refuse before they build anything. Plain Python on the CPU: no JAX, no
device."""

import pytest
import torch

from valle_tpu_torch.ops import decode_attention as dt8
from valle_tpu_torch.ops import decode_attention_int8_grouped as d8
from valle_tpu_torch.ops import fused_attn_tail as fat


@pytest.mark.parametrize("B,D,G", [(1, 1024, 8), (5, 1024, 8), (8, 1024, 8),
                                   (9, 1024, 16), (13, 1024, 16),
                                   (32, 1024, 16), (33, 1024, 16),
                                   (32, 640, 8), (13, 1152, 8),
                                   (32, 1280, 16), (32, 256, 16)])
def test_cluster_rows(B, D, G):
    """16 rows a cluster above B 8 where D / 16 is whole 16-column tiles,
    else 8 (the grid is padded to G); each block's D / G columns are whole
    tiles whenever D is a multiple of 128 (the fused modes' shape gate)."""
    assert fat.cluster_rows(B, D) == G
    assert (D // G) % 16 == 0


def _transposed_operands(Dh=64, v_dtype=torch.float32, v_contiguous=True):
    q = torch.zeros(2, 4, 1, Dh)
    k = torch.zeros(2, 4, Dh, 128)
    v = torch.zeros(2, 4, Dh, 128, dtype=v_dtype)
    if not v_contiguous:
        v = torch.zeros(2, 4, 128, Dh).transpose(-1, -2)
    return q, k, v


@pytest.mark.parametrize("case,match", [
    (dict(Dh=96), "head dim 96"),
    (dict(v_dtype=torch.bfloat16), "do not match"),
    (dict(v_contiguous=False), "contiguous"),
])
def test_transposed_launcher_refuses_operands(case, match):
    """B8's launcher raises a named error for a head dim the kernel was
    not built for, caches of another dtype than q, and a strided cache."""
    q, k, v = _transposed_operands(**case)
    with pytest.raises(ValueError, match=match):
        dt8.launch_transposed("decode_attention", q, k, v,
                              torch.ones(2, dtype=torch.int32),
                              torch.full((2,), 70), S=64)


def _int8_operands(Dh=64, T=128, kv_dtype=torch.int8, kv_contiguous=True,
                   sc_shape=None, sc_dtype=torch.float32,
                   sc_contiguous=True):
    B, H = 2, 4
    q = torch.zeros(B, H, 1, Dh)
    kv = torch.zeros(B, H, T, 2 * Dh, dtype=kv_dtype)
    if not kv_contiguous:
        kv = torch.zeros(B, T, H, 2 * Dh, dtype=kv_dtype).transpose(1, 2)
    sc = torch.ones(sc_shape or (B, 2 * H, T), dtype=sc_dtype)
    if not sc_contiguous:
        sc = torch.ones(B, T, 2 * H).transpose(1, 2)
    return q, kv, sc


@pytest.mark.parametrize("case,match", [
    (dict(Dh=96), "head dim 96"),
    (dict(kv_dtype=torch.bfloat16), "int8"),
    (dict(kv_contiguous=False), "contiguous"),
    (dict(sc_shape=(2, 4, 128)), "scales"),
    (dict(sc_dtype=torch.bfloat16), "scales"),
    (dict(sc_contiguous=False), "scales"),
    (dict(T=130), "multiple of 4"),
])
def test_int8_launcher_refuses_operands(case, match):
    """B3's launcher raises a named error for a head dim the kernel was
    not built for, a cache that is not int8 or is strided, scales of the
    wrong shape, dtype or layout, and a cache length whose scale rows
    would not start 16-byte aligned (the kernel's bulk copies need it)."""
    q, kv, sc = _int8_operands(**case)
    with pytest.raises(ValueError, match=match):
        d8.launch_int8("decode_attention_int8_grouped", q, kv, sc,
                       torch.ones(2, dtype=torch.int32),
                       torch.full((2,), 70), S=64)
