"""Probe of the device, the host library and the toolchain — the src/arch/
analog.

The JAX package probes its accelerator once (ceph_tpu/arch.py); the port
asks PyTorch.  ``probe()`` answers the JAX probe's keys with the same
meaning, cached after the first call (``refresh=True`` probes again):

- ``platform``/``device_kind``/``n_devices``: what the port's default
  device is, as ``mesh.topology.default_platform`` picks it: ``gpu``,
  the card's name and the card count when torch sees a card, else
  ``cpu``, ``cpu`` and 1 (the host is one torch device).
- ``x64``: whether int64 lanes compute exactly (the straw2 draws need
  them).
- ``pallas``: False: the port has no Pallas kernels.
- ``native``: the host C++ library (csrc_host/) is built and loaded; a
  failed build raises, as it does for every other caller.

Beside them, the port's own: the card's ``capability`` and
``sm_count``, ``torch``, ``torch_cuda`` and the ``nvcc`` path (the
kernels are built from source at first use, ops/_build.py).

CLI: ``python -m ceph_tpu_torch.arch`` prints the probe as one JSON line.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict

import torch


def find_nvcc() -> str | None:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.access(cand, os.X_OK) else None


_cache: Dict[str, Any] = {}


def probe(refresh: bool = False) -> Dict[str, Any]:
    global _cache
    if _cache and not refresh:
        return _cache
    from .native import native_available
    big = torch.tensor(3_000_000_019, dtype=torch.int64)
    out: Dict[str, Any] = dict(
        platform="cpu", device_kind="cpu", n_devices=1,
        x64=int(big * big) == 3_000_000_019 ** 2, pallas=False,
        native=native_available(),
        capability=None, sm_count=0,
        torch=torch.__version__, torch_cuda=torch.version.cuda,
        nvcc=find_nvcc())
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        out.update({
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0),
            "n_devices": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "sm_count": props.multi_processor_count,
        })
    _cache = out
    return out


if __name__ == "__main__":
    print(json.dumps(probe()))
