"""Native (C) components, built on first use with the system compiler.

``levenshtein`` mirrors the python-Levenshtein C dependency of the
reference's similarity validator (calculate_prompt_similarity.py):
``levenshtein.c`` is compiled by ``cc`` (or ``$CC``) into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
under a name that hashes the source, the compiler and the flags, and
loaded with :mod:`ctypes`.  Nothing is written into the package, and
nothing runs at import time.  A failed build or a failed allocation in the
C code raises: there is no quiet Python fallback.  ``_levenshtein_py`` is
the plain version the tests hold the C code against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "levenshtein.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CC", "cc")


def _target() -> str:
    """The library path: its name hashes the source, the compiler and the
    flags, so an edited source is rebuilt and a stale library never
    loads."""
    digest = hashlib.sha256(" ".join((_compiler(),) + CC_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"liblevenshtein-{digest.hexdigest()[:12]}.so")


def _build() -> ctypes.CDLL:
    target = _target()
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # each builder writes its own file and renames it into place, so
        # processes building at once never load a half-written library
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.run([_compiler(), *CC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building {_SRC} failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(target)
    lib.levenshtein_u32.restype = ctypes.c_size_t
    lib.levenshtein_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
    ]
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _build()
    return _lib


def _as_u32(s: str):
    data = s.encode("utf-32-le")
    n = len(data) // 4
    buf = (ctypes.c_uint32 * n).from_buffer_copy(data) if n else (ctypes.c_uint32 * 1)()
    return buf, n


def _levenshtein_py(a: str, b: str) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        curr = [i]
        for j, cb in enumerate(b, 1):
            cost = 0 if ca == cb else 1
            curr.append(min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + cost))
        prev = curr
    return prev[-1]


def levenshtein(a: str, b: str) -> int:
    """Edit distance over code points, computed by the C library."""
    lib = _get_lib()
    ba, la = _as_u32(a)
    bb, lb = _as_u32(b)
    out = lib.levenshtein_u32(ba, la, bb, lb)
    if out == ctypes.c_size_t(-1).value:
        raise MemoryError(f"levenshtein: allocation of {min(la, lb) + 1} "
                          "row entries failed")
    return int(out)


def normalized_levenshtein_similarity(a: str, b: str) -> float:
    """1 − d/max_len (the reference's normalized similarity)."""
    if not a and not b:
        return 1.0
    m = max(len(a), len(b))
    return 1.0 - levenshtein(a, b) / m


def using_native() -> bool:
    """True once the C library is built and loaded (a failed build
    raises)."""
    return _get_lib() is not None
