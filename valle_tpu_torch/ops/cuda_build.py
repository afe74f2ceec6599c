"""Build, load and count the port's CUDA kernels.

The sources under ``valle_tpu_torch/csrc/`` compile at first use, one
plain ``nvcc`` process per source started together
(``-gencode arch=compute_90a,code=sm_90a``), then link into one shared
library with a C interface, loaded with ``ctypes``. The library goes to
``build/valle_tpu_torch/`` beside the package under a name keyed on a hash
of the sources, so an edit rebuilds and an unchanged tree reuses the
build.

Every kernel wrapper calls ``count_launch(name)`` where it launches its
kernel, and nowhere else: one more in ``LAUNCHES[name]`` and, on a thread
inside ``shard_scope(i)`` (a serving mesh's shard), in
``SHARD_LAUNCHES[i][name]``; a run can then show that it went through the
kernels, and on which shard. A thread inside ``capture_launches()`` (a CUDA
graph's capture, whose kernels run only when it is replayed) counts into
that capture's own dict instead, which each replay adds with
``count_launch(name, n)``: the counts stay the launches run. Nothing here
runs at import time.

Several threads may launch at once, one a device or a stream (a serving
mesh): the build runs once under a lock, the counts are taken under a
lock, and ``stream_ptr`` refuses a launch whose tensors lie on another
card than the thread's current one (the C entry points read the current
device for their launch state, ``csrc/common.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
LAUNCHES = {"fused_ln_qkv": 0, "fused_tail": 0, "flash_mha_fwd": 0,
            "flash_mha_bwd": 0, "decode_attention_int8_grouped": 0,
            "decode_attention_kv": 0, "decode_attention_lanes": 0,
            "fused_attn_tail": 0, "flash_attention": 0,
            "flash_attention_lens": 0, "decode_attention": 0,
            "decode_attention_grouped": 0}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

SHARD_LAUNCHES = {}      # shard index -> {kernel name: launches}

_lib = None
_build_lock = threading.Lock()
_count_lock = threading.Lock()
_shard = threading.local()
_capture = threading.local()
build_info = {"seconds": None, "path": None, "log": ""}

_P, _I, _L, _F, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                        ctypes.c_float, ctypes.c_uint64)
# dtype, dh, q, k, v, qcode, kcode, qseg, kseg, add_diag, then the dropout
# (thresh, scale, seed, bits) of both flash entry points
_FLASH_IN = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _U64, _P]
_SIGNATURES = {
    # x, B, K, ln_w, ln_b, out, eps, stream (fp32)
    "vt_layer_norm_rows": [_P, _I, _I, _P, _P, _P, _F, _P],
    # dtype, w_int8, epi, x, B, K, w, N, wscale, bias, resid, out, ln_w,
    # ln_b, eps, stream
    "vt_dense_rows": [_I, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                      _P, _F, _P],
    # ... o, lse, B, H, S, T, sm_scale, stream
    "vt_flash_fwd": _FLASH_IN + [_P, _P, _I, _I, _I, _I, _F, _P],
    # ... out, lse, g, delta, dq, dk, dv, B, H, S, T, sm_scale, stream
    "vt_flash_bwd": _FLASH_IN + [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _F, _P],
    # dtype, dh, q, q_bstride, kv, [scales,] x_lens, write_pos, out, B, H,
    # T, S, sm_scale, stream
    "vt_decode_attention_int8": [_I, _I, _P, _L, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _F, _P],
    "vt_decode_attention_kv": [_I, _I, _P, _L, _P, _P, _P, _P, _I, _I, _I,
                               _I, _F, _P],
    "vt_decode_attention_lanes": [_I, _I, _P, _L, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _F, _P],
    # dtype, dh, q, q_bstride, kv, x_lens, write_pos, out_w, part, B, H, T,
    # S, sm_scale, cluster, stream
    "vt_attn_outproj": [_I, _I, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _I, _P],
    # dtype, part, B, H, D, out_b, resid, ln_w, ln_b, h1, nrm, eps, stream
    "vt_attn_tail_combine": [_I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _F,
                             _P],
    # dtype, dh, q, k, v, their (b, h, t) strides, bias, its (b, h, i)
    # strides, x_lens, y_lens, S_text, causal, out, B, H, S, T, sm_scale,
    # stream
    "vt_flash_attention": [_I, _I, _P, _P, _P] + [_L] * 9 + [_P, _L, _L, _L,
                                                             _P, _P, _I, _I,
                                                             _P, _I, _I, _I,
                                                             _I, _F, _P],
    # dtype, dh, q, q_bstride, k_cache, v_cache, x_lens, write_pos, out, B,
    # H, T, S, sm_scale, stream
    "vt_decode_attention_t": [_I, _I, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _F, _P],
}


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        SHARD_LAUNCHES.clear()


def count_launch(name: str, n: int = 1) -> None:
    """``n`` launches of kernel ``name``: in ``LAUNCHES``, and in the
    calling thread's shard's ``SHARD_LAUNCHES`` entry inside
    ``shard_scope``; inside ``capture_launches`` in its dict alone."""
    captured = getattr(_capture, "counts", None)
    if captured is not None:
        captured[name] = captured.get(name, 0) + n
        return
    with _count_lock:
        LAUNCHES[name] += n
        shard = getattr(_shard, "index", None)
        if shard is not None:
            per = SHARD_LAUNCHES.setdefault(shard, dict.fromkeys(LAUNCHES, 0))
            per[name] += n


@contextmanager
def capture_launches():
    """Count the calling thread's launches into the dict it yields, not
    into ``LAUNCHES``: they are recorded into a CUDA graph, not run."""
    prev = getattr(_capture, "counts", None)
    _capture.counts = counts = {}
    try:
        yield counts
    finally:
        _capture.counts = prev


@contextmanager
def shard_scope(index: int):
    """Count the calling thread's launches under shard ``index`` too."""
    prev = getattr(_shard, "index", None)
    _shard.index = index
    try:
        yield
    finally:
        _shard.index = prev


BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "valle_tpu_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process.
    The first caller builds and loads under a lock; a thread that comes
    meanwhile waits for it and takes the same library."""
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            _build_and_load()
    return _lib


def _build_and_load() -> None:
    global _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")) + NVCC_FLAGS:
        digest.update(f.read_bytes() if isinstance(f, Path) else f.encode())
    out_dir = BUILD_DIR
    so = out_dir / f"libvalle_tpu_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(sources, objs)]
        _run_all(cmds)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
        build_info["seconds"] = time.perf_counter() - t0
        for o in objs:
            o.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    build_info["path"] = str(so)
    _lib = lib


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the log if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    build_info["log"] += "".join(logs)
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(c)}):\n{log}")


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = _lib.vt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The calling thread's current stream on ``t``'s card, for a launch
    on ``t``. Raises if that card is not the thread's current device: the
    C entry points take their launch state (function attributes, SM
    count) from the current device, so such a launch must not run."""
    current = torch.cuda.current_device()
    if t.device.index is not None and t.device.index != current:
        raise RuntimeError(
            f"kernel launch on {t.device} from a thread whose current "
            f"device is cuda:{current}: enter torch.cuda.device({t.device})"
            " first")
    return torch.cuda.current_stream(t.device).cuda_stream


def route(name: str, *tensors: torch.Tensor) -> str:
    """Dispatch rule shared by the kernel wrappers: all tensors on the CPU
    -> "plain"; all on CUDA -> "cuda"; anything else raises."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return "plain"
    if devs == {"cuda"}:
        return "cuda"
    raise RuntimeError(f"{name}: no kernel for devices {sorted(devs)}; "
                       "tensors must all be on CUDA (kernel) or all on the "
                       "CPU (plain version)")


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")
