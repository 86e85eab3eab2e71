"""Build a kernel's CUDA source with ``nvcc`` at first use and bind it.

Each kernel package keeps its CUDA sources under ``csrc/``; each library is
one ``.cu`` file there with a plain C interface.  :class:`CudaLibrary`
compiles it for ``sm_90a`` into ``build/kernels/`` at the repository root
and loads it with ``ctypes``.  The library's file name carries a hash of
every file under its ``csrc/``, of every header outside it that they
include (``#include "../../common/hopper.cuh"``), and of the compiler
flags, so an edited source, header or flag never reuses a stale build.  A
library may carry flags of its own (include paths, link libraries) beside
the common ones.  :meth:`CudaLibrary.start` only launches the compiler,
so a caller that needs several kernels starts every build first and then
waits on each (``get``): the builds run side by side.
:func:`tma_strides` says whether the wgmma kernels' TMA can read an
operand as it lies.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: flags every library is compiled with
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_TEXT_SUFFIXES = (".cu", ".cuh", ".h", ".hpp", ".inl")


class CudaLibrary:
    """One kernel's shared library, built and loaded once per process.

    ``bind`` sets ``argtypes``/``restype`` on the loaded ``ctypes.CDLL``;
    ``extra_flags`` follow the source on the nvcc command line (so link
    libraries such as ``-lcuda`` come after it)."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        self.source = Path(source)
        self.extra_flags = tuple(extra_flags)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None
        self._tmp: Optional[Path] = None
        self._t0 = 0.0
        #: compiler output of the build (``-Xptxas -v`` register report)
        self.build_log = ""
        self.build_seconds = 0.0
        self.path: Optional[Path] = None

    def flags(self) -> List[str]:
        """The compiler flags, without the source and output paths."""
        return [*COMMON_FLAGS, *self.extra_flags]

    def inputs(self) -> List[Path]:
        """Every file the build reads: each file under the source's
        directory, then each header outside it reached through a quoted
        ``#include`` (resolved from the including file's directory, and
        followed into the headers it includes in turn)."""
        root = self.source.parent.resolve()
        own = sorted(p.resolve() for p in root.rglob("*") if p.is_file())
        seen, todo, shared = set(own), list(own), []
        while todo:
            f = todo.pop()
            if f.suffix not in _TEXT_SUFFIXES:
                continue
            for name in _INCLUDE.findall(f.read_text(errors="replace")):
                dep = (f.parent / name).resolve()
                if dep.is_file() and dep not in seen:
                    seen.add(dep)
                    shared.append(dep)
                    todo.append(dep)
        return own + sorted(shared)

    def target(self) -> Path:
        """Where the build goes: named by a hash of :meth:`inputs` (path
        relative to the source's directory, and bytes) and of
        :meth:`flags`."""
        h = hashlib.sha256()
        root = self.source.parent.resolve()
        for f in self.inputs():
            h.update(Path(os.path.relpath(f, root)).as_posix().encode()
                     + b"\0")
            h.update(f.read_bytes() + b"\0")
        h.update("\0".join(self.flags()).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start_locked(self) -> None:
        if self._lib is not None or self._proc is not None:
            return
        self.path = self.target()
        if self.path.exists():
            return
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found (looked on PATH and in "
                               f"{cuda_home}/bin); cannot build {self.source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *COMMON_FLAGS, "-o", str(self._tmp), str(self.source),
               *self.extra_flags]
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)

    def start(self) -> None:
        """Launch the compiler if the library is not built yet; return at
        once."""
        with self._lock:
            self._start_locked()

    def get(self) -> ctypes.CDLL:
        """The loaded library; builds it first (or waits for
        :meth:`start`'s build).  Raises if the build fails."""
        with self._lock:
            if self._lib is None:
                self._start_locked()
                if self._proc is not None:
                    out, _ = self._proc.communicate()
                    self.build_seconds = time.perf_counter() - self._t0
                    self.build_log = out or ""
                    rc, self._proc = self._proc.returncode, None
                    if rc != 0:
                        raise RuntimeError(f"nvcc failed ({rc}) on "
                                           f"{self.source}:\n{self.build_log}")
                    # atomic: a racing process sees all or nothing
                    os.replace(self._tmp, self.path)
                lib = ctypes.CDLL(str(self.path))
                self._bind(lib)
                self._lib = lib
            return self._lib


def check_launch(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def require_local(*tensors) -> None:
    """Raise for a DTensor: a kernel takes each rank's local shard (the
    model runs it inside ``local_call``), and a DTensor has no data
    pointer of its own."""
    for t in tensors:
        if hasattr(t, "placements"):
            raise TypeError("a CUDA kernel got a DTensor: call it on local "
                            "shards (under the sharding policy)")


def tma_strides(t) -> Optional[Tuple[int, ...]]:
    """The element strides of every dimension of tensor ``t`` but the last
    under which TMA can read it as it lies, or None when it must be copied
    first.

    TMA needs a 16-byte aligned base, unit stride along the last
    dimension, and the other strides positive multiples of 16 bytes.  A
    dimension of size 1 is never stepped along, so its stride is replaced
    by the last dimension's length, which qualifies for the wgmma kernels'
    rows (a multiple of 8 elements of 2 or 4 bytes)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    es = t.element_size()
    out = []
    for dim in range(t.dim() - 1):
        n, s = t.shape[dim], t.stride(dim)
        if n == 1:
            s = t.shape[-1]
        elif s <= 0 or (s * es) % 16:
            return None
        out.append(s)
    return tuple(out)
