"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>_<hash>.so`` at
the root of the checkout, at first use, keyed by a hash of the source and
the flags, and loaded with :mod:`ctypes`.  Nothing is compiled or loaded
when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(candidate)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path and the compiler's report (empty when it was cached)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True,
        text=True,
        check=False,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))
