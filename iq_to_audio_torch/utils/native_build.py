"""Build the optional host C++ helpers under ``native/`` for the port.

The sources are read, never edited, and nothing is written beside them:
each library is compiled with ``g++`` into
``build/torch_native/lib<name>_<hash>.so`` at the root of the checkout, at
first use, keyed by a hash of the source and the flags, and loaded with
:mod:`ctypes`.  Compile and link are separate steps so that a source may be
compiled with ``-ffast-math`` while the shared object is linked without it:
linking with it pulls in ``crtfastmath.o``, whose constructor sets FTZ/DAZ
for the whole process on ``dlopen``.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

LOG = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_BASE_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")


def build_native(name: str, source: str, compile_flags: tuple[str, ...] = ()) -> Path | None:
    """Compile ``native/<source>`` into ``lib<name>_<hash>.so`` unless it is
    there already.  Returns the library's path, or ``None`` when the source
    or ``g++`` is missing or the build fails (the helpers are optional)."""
    src = NATIVE_DIR / source
    gxx = shutil.which("g++")
    if gxx is None or not src.exists():
        return None
    flags = (*_BASE_FLAGS, *compile_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # fresh names, then a rename: a mapped library is never rewritten in place
    obj = out.with_name(f"{out.name}.{os.getpid()}.o")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [gxx, *flags, "-c", str(src), "-o", str(obj)],
            check=True, capture_output=True, timeout=180,
        )
        subprocess.run(
            [gxx, "-shared", "-o", str(tmp), str(obj)],
            check=True, capture_output=True, timeout=180,
        )
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, OSError) as exc:
        LOG.debug("native build of %s failed: %s", source, exc)
        tmp.unlink(missing_ok=True)
        return None
    finally:
        obj.unlink(missing_ok=True)
