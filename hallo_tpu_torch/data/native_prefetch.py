"""ctypes binding of the C++ file prefetcher (`csrc/prefetch.cpp`), the
port's counterpart of hallo_tpu/data/native_prefetch.py.

The library is host code: it is compiled with the host's C++ compiler
(`CXX`, g++ unless the environment names another) at first use into
`hallo_tpu_torch/_build/prefetch-<hash>.so`, where the hash covers the
source and the flags. `data/datasets.batch_iterator` reads the training
clips through it.

Divergence from the JAX package (its `:33-37` and `:84-95`): a build that
fails, or a prefetcher the library cannot open, raises, where JAX's falls
back to synchronous reads. A file that cannot be read raises `IOError`, as
there.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import itertools
import os
import subprocess
import threading
from typing import Iterator, List, Optional

import numpy as np

from hallo_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "prefetch.cpp")
CXX = os.environ.get("CXX", "g++")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_library(cxx: str = CXX, build_dir: str = BUILD_DIR) -> str:
    """Compile `csrc/prefetch.cpp` into `build_dir` unless it is built
    already; returns the library's path. Raises RuntimeError when the
    compiler is missing or fails."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(build_dir, f"prefetch-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the prefetcher's build could not start {cxx}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for prefetch.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same hash is harmless
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.pf_open.restype = ctypes.c_void_p
            lib.pf_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                                    ctypes.c_long, ctypes.c_long, ctypes.c_int]
            lib.pf_next.restype = ctypes.c_long
            lib.pf_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                                    ctypes.POINTER(ctypes.c_size_t)]
            lib.pf_release.argtypes = [ctypes.POINTER(ctypes.c_char)]
            lib.pf_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class FilePrefetcher:
    """The contents (bytes) of `paths`, in order, read ahead by `workers`
    threads into a ring of `capacity` files; with `loop`, the list again
    and again."""

    _handle = None

    def __init__(self, paths: List[str], capacity: int = 8, workers: int = 2,
                 loop: bool = False):
        self.paths = list(paths)
        self._lib = _load()
        self._paths_arr = (ctypes.c_char_p * len(self.paths))(
            *[os.fsencode(p) for p in self.paths])  # kept alive with the handle
        self._handle = self._lib.pf_open(self._paths_arr, len(self.paths), capacity,
                                         workers, int(loop))
        if not self._handle:
            raise ValueError(f"pf_open refused {len(self.paths)} paths, capacity {capacity}, "
                             f"{workers} workers")

    def __iter__(self) -> Iterator[bytes]:
        data = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_size_t()
        for i in itertools.count():
            idx = self._lib.pf_next(self._handle, ctypes.byref(data), ctypes.byref(size))
            if idx == -1:
                return
            if idx == -2:
                raise IOError(f"the prefetcher could not read {self.paths[i % len(self.paths)]}")
            try:
                yield ctypes.string_at(data, size.value)
            finally:
                self._lib.pf_release(data)

    def iter_npz(self) -> Iterator[dict]:
        for blob in self:
            yield dict(np.load(io.BytesIO(blob), allow_pickle=False))

    def close(self) -> None:
        if self._handle:
            self._lib.pf_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
