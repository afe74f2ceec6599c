"""Milliseconds of codec work per second of audio answered by the
window's engine calls: the prompt encodes of their requests (each
prepared alone before the call) and their batch's decode, each
synchronized (the codec hands numpy arrays back)."""

from portbench.metrics._serve import window_calls


def read(data):
    calls = [c for c in window_calls(data) if "codec_decode_s" in c]
    rate = data["cfg"]["codec"]["frame_rate"]
    audio_s = sum(sum(c["frames"]) for c in calls) / rate
    codec_s = sum(c["encode_s"] + c["codec_decode_s"] for c in calls)
    return 1e3 * codec_s / audio_s if audio_s else None
