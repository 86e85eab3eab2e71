"""Build a kernel's CUDA source with ``nvcc`` at first use and bind it.

Each kernel package keeps one ``csrc/*.cu`` file with a plain C interface.
:class:`CudaLibrary` compiles it for ``sm_90a`` into ``build/kernels/`` at
the repository root, named by a hash of the source so an edit rebuilds,
and loads it with ``ctypes``.  :meth:`CudaLibrary.start` only launches the
compiler, so a caller that needs several kernels starts every build first
and then waits on each (``get``): the builds run side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


class CudaLibrary:
    """One kernel's shared library, built and loaded once per process.

    ``bind`` sets ``argtypes``/``restype`` on the loaded ``ctypes.CDLL``."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
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

    def _target(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def _start_locked(self) -> None:
        if self._lib is not None or self._proc is not None:
            return
        self.path = self._target()
        if self.path.exists():
            return
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found (looked on PATH and in "
                               f"{cuda_home}/bin); cannot build {self.source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(self._tmp), str(self.source)]
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
