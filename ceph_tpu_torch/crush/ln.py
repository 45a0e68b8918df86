"""crush_ln: fixed-point 2^44*log2(x+1) via lookup tables.

Semantics identical to the reference straw2 draw's log (src/crush/mapper.c
crush_ln, :243-290): normalize x+1 into [2^15, 2^17), split into a
table-indexed high part and an interpolated low part, both via the LUTs in
_ln_table_data.  Exactness here decides straw2 argmax winners, so the whole
path is integer.
"""
from __future__ import annotations

import numpy as np

from ._ln_table_data import RH_LH_TBL, LL_TBL

# numpy copies for the vectorized host mapper / device upload
RH_LH_NP = np.array(RH_LH_TBL, dtype=np.uint64)
LL_NP = np.array(LL_TBL, dtype=np.uint64)


def crush_ln(xin: int) -> int:
    x = (xin + 1) & 0xFFFFFFFF

    # normalize into [2^15, 2^17): find shift so bit 15 or 16 set
    iexpon = 15
    if not (x & 0x18000):
        bits = 16 - (x & 0x1FFFF).bit_length()
        x <<= bits
        iexpon = 15 - bits

    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]          # ~ 2^56/index1
    lh = RH_LH_TBL[index1 + 1 - 256]      # ~ 2^48*log2(index1/256)

    xl64 = (x * rh) >> 48                 # ~ 2^48*(2^15 + x%2^8) scaled
    index2 = xl64 & 0xFF
    ll = LL_TBL[index2]                   # ~ 2^48*log2(1+index2/2^15)

    result = iexpon << (12 + 32)
    result += (lh + ll) >> (48 - 12 - 32)
    return result


def crush_ln_np(xin: np.ndarray) -> np.ndarray:
    """Vectorized crush_ln over uint32 inputs (0..0xffff expected)."""
    x = (xin.astype(np.uint64) + 1) & np.uint64(0xFFFFFFFF)
    # bit-length based normalization: values are <= 0x10000 here
    iexpon = np.full(x.shape, 15, dtype=np.int64)
    need = (x & np.uint64(0x18000)) == 0
    # compute number of leading shifts for values below 2^15
    xs = x.copy()
    for _ in range(15):  # bounded: x >= 1
        m = need & ((xs & np.uint64(0x18000)) == 0)
        if not m.any():
            break
        xs = np.where(m, xs << np.uint64(1), xs)
        iexpon = np.where(m, iexpon - 1, iexpon)
    x = xs
    index1 = ((x >> np.uint64(8)) << np.uint64(1)).astype(np.int64)
    rh = RH_LH_NP[index1 - 256]
    lh = RH_LH_NP[index1 + 1 - 256]
    xl64 = (x * rh) >> np.uint64(48)
    index2 = (xl64 & np.uint64(0xFF)).astype(np.int64)
    ll = LL_NP[index2]
    result = (iexpon.astype(np.uint64) << np.uint64(44)) + \
        ((lh + ll) >> np.uint64(4))
    return result
