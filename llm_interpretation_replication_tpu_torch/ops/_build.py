"""Build the port's CUDA sources (``ops/csrc/*.cu``) into shared libraries.

Each source is compiled on first use by ``nvcc`` for Hopper (``sm_90a``)
into a ``.so`` with a plain C interface and loaded with :mod:`ctypes`;
:func:`build_all` compiles several at once, one ``nvcc`` each.  The
library name carries a hash of the source, of every ``csrc/*.cuh`` header
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  ``nvcc`` finds a header beside the source that
includes it.  Builds go to
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  Each build started calls the registered build listeners
with the source's name (``runtime.strict.RecompileSentry`` counts them).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildRecord:
    path: str
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/spill lines)


_records: Dict[str, BuildRecord] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_listeners: List[Callable[[str], None]] = []


def add_build_listener(fn: Callable[[str], None]) -> None:
    """Call ``fn(name)`` for every ``nvcc`` build started (idempotent per
    callable)."""
    if fn not in _listeners:
        _listeners.append(fn)


def remove_build_listener(fn: Callable[[str], None]) -> None:
    if fn in _listeners:
        _listeners.remove(fn)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> str:
    """The library path for ``csrc/<name>.cu``: its name hashes the source,
    every header of ``csrc/`` (a source may include any of them) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names) -> Dict[str, BuildRecord]:
    """Build every ``ops/csrc/<name>.cu`` of ``names`` that is not built yet:
    one ``nvcc`` for each source, all started together, each waited for.
    Raises with nvcc's output if any build failed."""
    started = {}
    for name in names:
        if name in _records:
            continue
        out = _target(name)
        if os.path.exists(out):
            _records[name] = BuildRecord(out, 0.0, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (out, tmp, time.perf_counter(), proc)
        for fn in list(_listeners):
            fn(name)
    failed = []
    for name, (out, tmp, t0, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        _records[name] = BuildRecord(out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _records[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(build_all([name])[name].path)
    return lib
