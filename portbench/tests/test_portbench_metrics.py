"""The metric arithmetic: the tail with failures as misses, the
readers over synthetic spans, the idle share of a synthetic trace, the
roofline formulas against hand counts and the FLOP counter against the
port's parameter count."""

import math

import pytest
import torch

from portbench import roofline
from portbench.drivers.open_loop_http import _quantile
from portbench.run import read_metric
from portbench.trace import reduce_events


def test_p95_counts_failures_as_misses():
    lat = [float(i) for i in range(1, 101)]
    assert _quantile(lat, 0.95) == 95.0
    lat[:5] = [math.inf] * 5          # five misses move the tail
    assert _quantile(lat, 0.95) == 100.0
    lat[:6] = [math.inf] * 6
    assert _quantile(lat, 0.95) == math.inf


def _data(trace=None):
    """Two engine calls in a window [100, 150), one before it."""
    reqs = [dict(id=i, due=d, stretch=s) for i, (d, s) in enumerate(
        [(-5.0, "lead_in"), (1.0, "window"), (2.0, "window"),
         (30.0, "window")])]
    calls = [
        dict(start=98.0, end=110.0, ids=[0], frames=[100], encode_s=0.01,
             codec_decode_s=0.1, ar=dict(B=1, steps=101, ar_s=1.0)),
        dict(start=110.0, end=130.0, ids=[1, 2], frames=[150, 50],
             encode_s=0.02, codec_decode_s=0.2,
             ar=dict(B=2, steps=151, ar_s=3.02)),
        dict(start=130.0, end=140.0, ids=[3], frames=[75], encode_s=0.01,
             codec_decode_s=0.1, ar=dict(B=1, steps=76, ar_s=0.76)),
    ]
    return dict(requests=reqs, calls=calls, window=(100.0, 150.0),
                trace=trace, cfg=dict(codec=dict(frame_rate=75),
                                      model=dict(d_model=64, nhead=2,
                                                 num_layers=2,
                                                 num_audio_tokens=1024)))


def test_span_readers():
    d = _data()
    assert read_metric("queue_wait_p50_s.serve", d) == pytest.approx(8.0)
    assert read_metric("batch_rows.serve", d) == pytest.approx(1.5)
    # 275 frames answered of 2 x 151 + 76 row-steps
    assert read_metric("ar_waste_share.serve", d) == pytest.approx(
        100 * (1 - 275 / 378))
    assert read_metric("ar_ms_per_step.serve", d) == pytest.approx(
        1e3 * 3.78 / 227)
    assert read_metric("codec_ms_per_audio_s.serve", d) == pytest.approx(
        1e3 * 0.33 / (275 / 75))


def test_trace_readers_need_a_trace():
    d = _data()
    for name in ("idle_share.serve", "mfu.serve", "decode_attn_roofline"):
        assert read_metric(name, d) is None


def test_idle_share_of_a_synthetic_trace():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 0,
           "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 100, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 250, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 900,
           "dur": 100}]
    t = reduce_events(ev)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(350e-6)     # 100-350, 900-1000
    assert read_metric("idle_share.serve", _data(t)) == pytest.approx(65.0)
    assert t["idle_gaps"] == [["aten::item", pytest.approx(650e-6)]]


def test_decode_attention_bytes_by_hand():
    # 2 rows of 10 and 20 valid keys, 2 heads of 4: int8 K and V (8 B a
    # key a head) plus two fp32 scales, q and out in bf16, two int32s a row
    assert roofline.decode_attn_bytes([10, 20], 2, 4, "int8") == (
        30 * 2 * (8 + 8) + 2 * 2 * 4 * 2 * 2 + 2 * 8)
    assert roofline.decode_attn_bytes([10, 20], 2, 4, "bf16") == (
        30 * 2 * 16 + 2 * 2 * 4 * 2 * 2 + 2 * 8)
    assert roofline.decode_attn_flops([10, 20], 2, 4) == 4 * 30 * 8
    assert roofline.roofline_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.roofline_s(0, 989e12) == pytest.approx(1.0)


def test_decode_attn_roofline_over_a_slice():
    ctx = dict(mode="int8", g0=10, n=2, x_lens=[5, 5], p_lens=[20, 30],
               gen_lens=[50, 50], rows=2)
    bound = sum(roofline.roofline_s(
        roofline.decode_attn_bytes([25 + g + 1, 35 + g + 1], 2, 32, "int8"),
        roofline.decode_attn_flops([25 + g + 1, 35 + g + 1], 2, 32))
        for g in (10, 11)) * 2
    kern = "void decode_int8_kernel<64>(...)"
    t = dict(window_s=1.0, busy_s=0.5, ctx=ctx,
             kernels={kern: [(0.0, 1e-6)] * 4, "other": [(0.0, 1.0)]})
    assert read_metric("decode_attn_roofline", _data(t)) == pytest.approx(
        100 * bound / 4e-6)


def test_step_flops_match_the_port_parameter_count():
    from valle_tpu_torch.models.valle import VALLE, ValleConfig

    with torch.device("meta"):
        m = VALLE(ValleConfig(d_model=128, nhead=2, num_layers=3))
    matrices = sum(p.numel() for n, p in m.ar_decoder.named_parameters()
                   if p.ndim == 2)
    assert roofline.stack_params(128, 3) == matrices
    head = m.ar_predict_layer.weight.numel()
    assert roofline.ar_step_flops(0, 128, 3, 1025) == 2 * (matrices + head)
    assert roofline.ar_step_flops(7, 128, 3, 1025) - roofline.ar_step_flops(
        0, 128, 3, 1025) == 3 * 4 * 7 * 128


def test_mfu_counts_live_rows_only():
    ctx = dict(mode="int8", g0=0, n=1, x_lens=[5, 5, 5], p_lens=[1, 1, 1],
               gen_lens=[1, 0, 1], rows=2)
    t = dict(window_s=1.0, busy_s=0.5, ctx=ctx, kernels={})
    want = roofline.ar_step_flops(7, 64, 2, 1025)   # row 0 alone
    assert read_metric("mfu.serve", _data(t)) == pytest.approx(
        100 * want / 989e12)
