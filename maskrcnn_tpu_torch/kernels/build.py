"""Build and load a hand-written CUDA source as a ``ctypes`` library.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` on first use into ``_build/`` (keyed by a hash of the
source and the flags, so a rebuild happens only when either changes) and
loaded with ``ctypes``. Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaLibrary:
    """One ``csrc`` source and its exported C functions.

    ``functions`` maps each exported name to its ``ctypes`` argument types;
    every function returns the ``cudaError_t`` of its launch as an int.
    ``load()`` builds if needed and returns the ``ctypes.CDLL``; it raises
    when ``nvcc`` is missing or fails. ``build_log`` keeps the compiler's
    output (registers, shared memory, spills) of a build made by this
    process.
    """

    def __init__(self, source: str, functions: dict[str, list]):
        self.source = CSRC_DIR / source
        self.functions = functions
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{key.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.library_path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    proc = subprocess.run(
                        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                        capture_output=True, text=True)
                    self.build_log = proc.stdout + proc.stderr
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({proc.returncode}):\n{self.build_log}")
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
            return lib
