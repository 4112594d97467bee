"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, from the package's own sources, into ``auncel_tpu_torch/_build/``
(git-ignored). The library's file name carries a hash of the source, the
shared headers and the flags, so an edited source or header rebuilds and
an unchanged one loads as is.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build time (0.0 when a built library was found),
#          "log": nvcc's output (ptxas register/shared-memory report)}
BUILD_INFO: dict = {}
_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """The library's path, keyed by ``csrc/<name>.cu``, every shared header
    ``csrc/*.cuh`` (which the sources include) and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if so.exists():
        BUILD_INFO[name] = {"seconds": 0.0, "log": ""}
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builds agree
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "log": proc.stdout + proc.stderr}
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
