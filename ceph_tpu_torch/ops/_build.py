"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/ceph_tpu_torch/<name>-<hash>.so`` at the root of
the checkout (git-ignored), where the hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags: an edited source or header
rebuilds, an unchanged one is reused.  Only
sources inside this package are built.  A missing ``nvcc`` or a failed
compile raises with the compiler's output; nothing falls back.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <so> csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

from ..arch import find_nvcc

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ceph_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register/spill report) of each build, by name
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of every CUDA source of the package (``csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its current build exists."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    so = library_path(name)
    if so.is_file():
        return so
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(f"cannot build {src.name}: nvcc not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    build_logs[name] = proc.stdout + proc.stderr
    return so


def build_all() -> Dict[str, Path]:
    """Build every source at once: one nvcc process each, all started
    together.  Raises the first failure after all have finished."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futs = {n: ex.submit(build, n) for n in names}
    return {n: f.result() for n, f in futs.items()}


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C function to (argtypes, restype), set once on first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _libs[name] = lib
        return lib
