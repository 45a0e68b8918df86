"""Chip-physics sanity model: no reading above peak survives unflagged.

Port of ``ceph_tpu/bench/roofline.py``.  Every throughput reading is
converted to the op and byte rates it implies, compared against the
backend's physical ceilings, and stamped ``suspect: true`` when it
exceeds either.  A suspect reading still gets reported (the raw data is
evidence of a broken fence), but the schema carries the verdict so it
can never silently become a headline.

Peaks are per single chip, from public spec sheets.  The port adds the
NVIDIA H100 (SXM, dense, at its full 700 W limit): 1979 int8 TOPS and
3.35e12 B/s of HBM.  ``H100_INT8_OPS_PER_S`` and
``H100_HBM_BYTES_PER_S`` are the one definition of those two peaks;
``chip_smoke.py``'s bounds read them from here.  The CPU entry is a
deliberately generous bound so only cache artifacts trip it, not honest
readings on a fast host.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates without sparsity
H100_INT8_OPS_PER_S = 1979e12
H100_HBM_BYTES_PER_S = 3.35e12

# (int8_tops, hbm_gibs) per backend, single chip/core.  device_kind
# substrings are matched case-insensitively; first hit wins.
CHIP_SPECS = {
    # NVIDIA Hopper, matched on torch.cuda.get_device_name()
    "h100": {"int8_tops": H100_INT8_OPS_PER_S / 1e12,
             "hbm_gibs": H100_HBM_BYTES_PER_S / (1 << 30)},
    # TPU generations (public peak specs; int8 where published, else
    # 2x the bf16 figure which is the MXU's int8 ratio)
    "v5e": {"int8_tops": 394.0, "hbm_gibs": 760.0},
    "v5 lite": {"int8_tops": 394.0, "hbm_gibs": 760.0},
    "v5p": {"int8_tops": 918.0, "hbm_gibs": 2587.0},
    "v4": {"int8_tops": 275.0, "hbm_gibs": 1130.0},
    "v6e": {"int8_tops": 1836.0, "hbm_gibs": 1530.0},
    "v6": {"int8_tops": 1836.0, "hbm_gibs": 1530.0},
    "v3": {"int8_tops": 123.0, "hbm_gibs": 855.0},
    # Generous host ceiling: ~2 int8 TOPS covers any AVX-512 box this
    # runs on; memory bound matches big dual-socket DDR5.
    "cpu": {"int8_tops": 2.0, "hbm_gibs": 600.0},
}

# Workload cost models: device int8 ops and HBM bytes per byte of
# OBJECT data (the unit the GiB/s metrics are denominated in).
#
# EC encode k=8,m=4 as the MXU bit-matmul: each C-element contracts
# (k*8) bit lanes against (m*8) output lanes = 64*32 MACs over k=8 data
# bytes -> 2*64*32/8 = 512 int8 ops per data byte.  HBM traffic per
# data byte: read 1 (data), write m/k (parity), plus the 8x-unpacked
# bit planes if XLA fails to fuse them — use the fused lower bound for
# the roofline (suspect flags on the compute axis are what matter).
EC_ENCODE_K8M4 = {
    "name": "ec_encode_k8m4",
    "ops_per_byte": 512.0,
    "hbm_bytes_per_byte": 1.0 + 4.0 / 8.0,
}
# Decode with e erasures runs the identical contraction shape (the
# inverted matrix has k columns; output rows differ but the dominant
# cost is the same bits @ B) — reconstructing e rows from k survivors
# is 2*(k*8)*(e*8)/8 ops per survivor byte; e=2 -> 256.
EC_DECODE_K8M4 = {
    "name": "ec_decode_k8m4_e2",
    "ops_per_byte": 256.0,
    "hbm_bytes_per_byte": 1.0 + 2.0 / 8.0,
}

# The port's salted step (workloads._salted_step): a torch XOR reads
# the batch and writes its salted copy (2 bytes per data byte), then K1
# reads the copy (1) and writes r/k.  K1 is nibble-table lookups and
# XORs on the integer pipes, no int8 MACs, so the int8 peak bounds
# nothing here: the op axis is 0 and the verdict rests on the bytes the
# step really moves.  The JAX models above stay as they were.
EC_ENCODE_K8M4_SALTED = {
    "name": "ec_encode_k8m4_salted",
    "ops_per_byte": 0.0,
    "hbm_bytes_per_byte": 2.0 + 1.0 + 4.0 / 8.0,
}
EC_DECODE_K8M4_SALTED = {
    "name": "ec_decode_k8m4_e2_salted",
    "ops_per_byte": 0.0,
    "hbm_bytes_per_byte": 2.0 + 1.0 + 2.0 / 8.0,
}


def chip_spec(platform: str, device_kind: str = "") -> Optional[Dict[str, float]]:
    """Resolve (platform, device_kind) to physical peaks, or None when
    the backend is unknown (verdict becomes "unknown", never "ok")."""
    kind = (device_kind or "").lower()
    for key, spec in CHIP_SPECS.items():
        if key != "cpu" and key in kind:
            return dict(spec)
    if platform == "cpu":
        return dict(CHIP_SPECS["cpu"])
    if platform == "tpu" and not kind:
        # unknown TPU generation: use the most permissive known peak so
        # only physically impossible-anywhere numbers trip the flag
        return dict(CHIP_SPECS["v6e"])
    return None


def validate_reading(gibs: float, workload: Dict[str, Any],
                     platform: str, device_kind: str = "",
                     n_devices: int = 1) -> Dict[str, Any]:
    """Roofline verdict for a throughput reading.

    Returns ``{implied_tops, implied_hbm_gibs, peak_tops, peak_hbm_gibs,
    mfu, suspect, verdict}``.  ``suspect`` is True when the implied op
    or byte rate exceeds the chip's peak (scaled by ``n_devices``) —
    meaning the "measurement" cannot have been a measurement.
    """
    implied_tops = gibs * (1 << 30) * workload["ops_per_byte"] / 1e12
    implied_hbm = gibs * workload["hbm_bytes_per_byte"]
    out: Dict[str, Any] = {
        "workload": workload["name"],
        "implied_tops": round(implied_tops, 2),
        "implied_hbm_gibs": round(implied_hbm, 2),
    }
    spec = chip_spec(platform, device_kind)
    if spec is None:
        out.update(peak_tops=None, peak_hbm_gibs=None, mfu=None,
                   suspect=False, verdict="unknown")
        return out
    peak_tops = spec["int8_tops"] * max(n_devices, 1)
    peak_hbm = spec["hbm_gibs"] * max(n_devices, 1)
    mfu = implied_tops / peak_tops
    suspect = implied_tops > peak_tops or implied_hbm > peak_hbm
    out.update(peak_tops=peak_tops, peak_hbm_gibs=peak_hbm,
               mfu=round(mfu, 4), suspect=bool(suspect),
               verdict="suspect" if suspect else "ok")
    return out
