"""ctypes bindings for the port's native audio library (wav I/O, mixdown,
resampling).

A copy of ``valle_tpu/native`` (the port imports nothing of the JAX
package): ``audioio.cpp`` is the same source, and ``read_wav``,
``write_wav``, ``to_mono``, ``resample`` and ``convert_audio`` take the
same arguments and defaults. The library is compiled with ``g++`` at first
use into ``build/valle_tpu_torch/`` under a name keyed on a hash of the
source and flags; a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "audioio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "valle_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lib = None


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("frames", ctypes.c_int64),
        ("format", ctypes.c_int32),
        ("bits", ctypes.c_int32),
    ]


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libvalle_audio_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the audio library is compiled at "
                           "first use (set CXX to a C++17 compiler)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                          "-lm"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"audio library build failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.valle_read_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(f32p), ctypes.POINTER(_WavInfo)]
    lib.valle_read_wav.restype = ctypes.c_int
    lib.valle_free.argtypes = [ctypes.c_void_p]
    lib.valle_write_wav.argtypes = [
        ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32]
    lib.valle_write_wav.restype = ctypes.c_int
    lib.valle_to_mono.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                  f32p]
    lib.valle_resample_out_len.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.valle_resample_out_len.restype = ctypes.c_int64
    lib.valle_resample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f32p,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double]
    lib.valle_resample.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (audio (frames, channels) float32, sample_rate)."""
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_float)()
    info = _WavInfo()
    rc = lib.valle_read_wav(str(path).encode(), ctypes.byref(out),
                            ctypes.byref(info))
    if rc != 0:
        raise IOError(f"failed to read wav {path!r} (code {rc})")
    n = info.frames * info.channels
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.valle_free(out)
    return arr.reshape(info.frames, info.channels), int(info.sample_rate)


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """audio: (frames,) or (frames, channels) float32 in [-1, 1]."""
    lib = get_lib()
    a = np.ascontiguousarray(audio, dtype=np.float32)
    if a.ndim == 1:
        a = a[:, None]
    frames, channels = a.shape
    rc = lib.valle_write_wav(str(path).encode(), _ptr(a), frames, channels,
                             sample_rate, bits)
    if rc != 0:
        raise IOError(f"failed to write wav {path!r} (code {rc})")


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 1:
        return audio
    if audio.shape[1] == 1:
        return audio[:, 0]
    lib = get_lib()
    a = np.ascontiguousarray(audio, dtype=np.float32)
    out = np.empty((a.shape[0],), dtype=np.float32)
    lib.valle_to_mono(_ptr(a), a.shape[0], a.shape[1], _ptr(out))
    return out


def resample(audio: np.ndarray, sr_in: int, sr_out: int, *,
             zeros: int = 24, rolloff: float = 0.945,
             beta: float = 14.769656459379492) -> np.ndarray:
    """Mono windowed-sinc polyphase resample (julius-style defaults)."""
    if sr_in == sr_out:
        return np.asarray(audio, dtype=np.float32)
    lib = get_lib()
    a = np.ascontiguousarray(audio, dtype=np.float32)
    if a.ndim != 1:
        raise ValueError(f"resample expects mono audio, got shape {a.shape}")
    n_out = lib.valle_resample_out_len(len(a), sr_in, sr_out)
    out = np.empty((n_out,), dtype=np.float32)
    rc = lib.valle_resample(_ptr(a), len(a), sr_in, sr_out, _ptr(out),
                            zeros, rolloff, beta)
    if rc != 0:
        raise RuntimeError(f"resample failed (code {rc})")
    return out


def convert_audio(audio: np.ndarray, sr_in: int, sr_out: int,
                  channels_out: int = 1) -> np.ndarray:
    """Mixdown + resample (parity with encodec.utils.convert_audio)."""
    out = resample(to_mono(audio), sr_in, sr_out)
    if channels_out == 1:
        return out
    return np.repeat(out[:, None], channels_out, axis=1)
