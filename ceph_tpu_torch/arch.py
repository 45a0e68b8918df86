"""Probe of the CUDA card and the toolchain — the src/arch/ analog.

The JAX package probes its accelerator once (ceph_tpu/arch.py); the port
asks PyTorch about the card instead: its name, compute capability and SM
count, and whether ``nvcc`` is on ``PATH`` (the kernels are built from
source at first use, ops/_build.py).  ``probe()`` never raises: absent
features read as empty / False.

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


def probe() -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "platform": "none", "device_name": "", "n_devices": 0,
        "capability": None, "sm_count": 0,
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "nvcc": find_nvcc(),
    }
    if not torch.cuda.is_available():
        return out
    props = torch.cuda.get_device_properties(0)
    out.update({
        "platform": "gpu",
        "device_name": torch.cuda.get_device_name(0),
        "n_devices": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "sm_count": props.multi_processor_count,
    })
    return out


if __name__ == "__main__":
    print(json.dumps(probe()))
