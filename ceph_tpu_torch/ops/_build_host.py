"""Build the port's host C++ sources with g++ and load them with ctypes.

The host twin of ``ops/_build.py``: the sources under ``csrc_host/``
(the port's copies of the JAX package's native C++) are compiled on
first use into one ``build/ceph_tpu_torch/<name>-<hash>.so`` at the root
of the checkout (git-ignored).  The hash covers every source, the flags
and what ``-march=native`` means on this machine (g++'s resolved target
options), so an edited source, another flag or another CPU rebuilds and
an unchanged one is reused.  A missing ``g++`` or a failed compile
raises with the compiler's output; nothing falls back.  A g++ run is a
host build, not a device compile: the device-flow profiler does not
count it.

    g++ -O3 -march=native -fPIC -std=c++17 -shared -o <so> <sources>
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
from typing import Dict, Sequence

from ._build import BUILD_DIR

CSRC_HOST = Path(__file__).resolve().parent.parent / "csrc_host"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each g++ run of this process took, by library name
build_seconds: Dict[str, float] = {}


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cannot build the host library: g++ not found")
    return cxx


def _target_key(cxx: str) -> bytes:
    """What ``-march=native`` resolves to here: a library built for
    another CPU is never loaded on this one."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ cannot resolve -march=native "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    return proc.stdout.encode()


def library_path(name: str, sources: Sequence[str], cxx: str) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.encode())
        h.update((CSRC_HOST / src).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_target_key(cxx))
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``csrc_host/<sources>`` into one library unless its
    current build exists."""
    for src in sources:
        if not (CSRC_HOST / src).is_file():
            raise FileNotFoundError(f"no host source {CSRC_HOST / src}")
    cxx = find_cxx()
    so = library_path(name, sources, cxx)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp),
         *(str(CSRC_HOST / s) for s in sources)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {', '.join(sources)} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    return so


def load(name: str, sources: Sequence[str],
         signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load one host library; ``signatures`` maps
    each C function to (argtypes, restype), set once on first load.
    Threads that miss together build once: the build runs under the
    load lock."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _libs[name] = lib
        return lib
