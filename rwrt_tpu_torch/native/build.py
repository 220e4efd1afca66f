"""Build and load the native C++ polynomial solver (lazy, cached, gated).

``cpolyroots.cpp`` beside this file is compiled with ``g++`` at first use
into ``rwrt_tpu_torch/_build/libcpolyroots-<hash of the source>.so`` (never
beside the source), so an edited source rebuilds and an unchanged one loads
the library already built. The compile writes a temporary file and renames
it, so processes building at once never load a half-written library. When
no working toolchain is found, ``load`` returns None and the caller falls
back to numpy. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "cpolyroots.cpp"
BUILD_ROOT = SRC.parent.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the shared object for the current source lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"libcpolyroots-{digest}.so"


def _compile(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                        str(SRC)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Return the loaded library, building it if needed; None if
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.cpoly_roots_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, dp, dp, dp, dp,
            ctypes.c_int, ctypes.c_double,
        ]
        lib.cpoly_roots_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
