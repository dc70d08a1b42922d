"""Build the CUDA kernels in `hallo_tpu_torch/csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with nvcc for
sm_90a (Hopper) into `hallo_tpu_torch/_build/<name>-<hash>.so` at its first
use, where the hash covers the source, the shared headers (`csrc/*.cuh`)
and the flags, so an edited kernel or header is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import time: the CPU tests import
every module of the package without a compiler.

A build that fails raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
# The C entry points: (source under csrc/, C name, argument types), by the
# name `call` takes.
ENTRY_POINTS = {
    "flash_fwd_t": ("flash_fwd_t_sm90", "hallo_flash_fwd_t_sm90", [_P] * 5 + [_LLP, _F, _P]),
    "flash_fwd_t_encode_ns": ("flash_fwd_t_sm90", "hallo_flash_fwd_t_encode_ns",
                              [_P, _P, _LLP, _I]),
    "flash_fwd_sm90": ("flash_fwd_sm90", "hallo_flash_fwd_sm90",
                       [_P] * 6 + [_LLP] + [_I] * 5 + [_LL] * 4 + [_F] + [_I] * 5 + [_P]),
    "flash_fwd_d512": ("flash_fwd_d512_sm90", "hallo_flash_fwd_d512_sm90",
                       [_P] * 5 + [_LLP] + [_I] * 5 + [_LL] * 4 + [_F] + [_I] * 5 + [_P]),
    "flash_sm90_encode_ns": ("flash_fwd_sm90", "hallo_flash_sm90_encode_ns",
                             [_P] * 3 + [_LLP] + [_I] * 3),
    "int8_prelude": ("flash_int8_sm90", "hallo_int8_prelude", [_P] * 9 + [_LLP, _F, _P]),
    "flash_int8": ("flash_int8_sm90", "hallo_flash_int8_sm90", [_P] * 6 + [_LLP, _P]),
    "flash_int8_encode_ns": ("flash_int8_sm90", "hallo_flash_int8_encode_ns",
                             [_P] * 3 + [_LLP, _I]),
    "temporal_attn": ("temporal_attn_sm90", "hallo_temporal_attn_sm90",
                      [_P] * 4 + [_LLP, _F, _P]),
    "flash_bwd_dkv": ("flash_bwd_sm90", "hallo_flash_bwd_dkv_sm90",
                      [_P] * 9 + [_LLP, _LLP, _I, _F, _F, _P]),
    "flash_bwd_dq": ("flash_bwd_sm90", "hallo_flash_bwd_dq_sm90",
                     [_P] * 9 + [_LLP, _LLP, _I, _F, _F, _P]),
    "winograd_conv3x3": ("winograd", "hallo_winograd_conv3x3",
                         [_P] * 4 + [_LLP] + [_I] * 7 + [_P]),
    "layout_copy": ("layout_copy", "hallo_layout_copy", [_P, _P] + [_LL] * 3 + [_I, _P]),
}
SOURCES = tuple(dict.fromkeys(src for src, _, _ in ENTRY_POINTS.values()))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # nvcc's output (ptxas register/smem report)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> tuple:
    src = os.path.join(_CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header, so that editing a header rebuilds
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    build_log[name] = log
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile the named kernels (in parallel) unless already built."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _finish(name, _start(name))
        _, out = _target(name)
        handle = ctypes.CDLL(out)
        for src, fn_name, argtypes in ENTRY_POINTS.values():
            if src == name:
                fn = getattr(handle, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[name] = handle
        return handle


_fns: Dict[str, ctypes._CFuncPtr] = {}  # bound entry points, by `call`'s name


def call(entry: str, *args) -> None:
    """Launch the C entry point `ENTRY_POINTS[entry]`; raise on a CUDA error."""
    fn = _fns.get(entry)
    if fn is None:
        src, fn_name, _ = ENTRY_POINTS[entry]
        fn = _fns[entry] = getattr(lib(src), fn_name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")
