"""Whole-map batch PG mapping — the OSDMapMapping / ParallelPGMapper twin.

Port of ``ceph_tpu/osdmap/mapping.py``.  The reference computes pg ->
up/acting for every PG of every pool by sharding the per-PG pipeline over
a thread pool (src/osd/OSDMapMapping.h:17-165).  Here the crush evaluation
of a whole pool is one ``FastRule.map_batch`` on the card
(ops/crush_fast.py, kernels K7a/K7b, and K6 for the x they flag), and
the post-passes — nonexistent / down filtering, primary pick, primary
affinity (OSDMap.cc:1966-2117) — are vectorized numpy over (PGs, size)
arrays.  Sparse per-PG overrides
(pg_upmap, pg_upmap_items, pg_temp, primary_temp) re-run the exact scalar
pipeline for just those PGs, so the batch result is identical to
pg_to_up_acting_osds on every input.

Only a rule that cannot compile for the card (``UnsupportedRule``, or
``compile_map``'s ValueError, both raised before any launch) maps on the
host ``crush_do_rule``; a failure of ``map_batch`` itself raises.
``last_backend[pool]`` says which ran: "device" (the card), "cpu" (the
plain versions, when the caller asked for the CPU) or "host", and
``host_replayed[pool]`` how many of the pool's PGs ``crush_do_rule``
mapped on the host: all of them on the host route, none otherwise (the
x the candidate tables leave unresolved finish on K6 beside them).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..crush.constants import CRUSH_ITEM_NONE
from ..crush.hash import crush_hash32_2_np
from ..crush.mapper import crush_do_rule
from ..ops.crush_fast import compile_fast_rule
from ..ops.gf_matmul import resolve_device
from ..trace import g_perf_histograms, g_tracer, latency_axes
from .osdmap import (
    CEPH_OSD_DEFAULT_PRIMARY_AFFINITY, CEPH_OSD_EXISTS, CEPH_OSD_UP, OSDMap,
)
from .types import FLAG_HASHPSPOOL, pg_pool_t, pg_t

NONE = CRUSH_ITEM_NONE


def pool_pps(pool: pg_pool_t, pool_id: int, ps: np.ndarray) -> np.ndarray:
    """Vectorized raw_pg_to_pps (osd_types.cc:1412-1427)."""
    ps = ps.astype(np.uint32)
    mask = np.uint32(pool.pgp_num_mask)
    low = ps & mask
    stable = np.where(low < pool.pgp_num, low, ps & (mask >> np.uint32(1)))
    if pool.flags & FLAG_HASHPSPOOL:
        return crush_hash32_2_np(stable, np.uint32(pool_id))
    return stable + np.uint32(pool_id)


class PoolMapping:
    """Dense per-pool result arrays, one row per PG."""

    def __init__(self, up: np.ndarray, up_primary: np.ndarray,
                 acting: np.ndarray, acting_primary: np.ndarray,
                 shift: bool):
        self.up = up
        self.up_primary = up_primary
        self.acting = acting
        self.acting_primary = acting_primary
        self.shift = shift  # replicated pools compact; EC keeps NONE holes
        X, size = up.shape
        if shift:
            self.up_len = (up != NONE).sum(axis=1).astype(np.int32)
            self.acting_len = self.up_len.copy()
        else:
            self.up_len = np.full(X, size, dtype=np.int32)
            self.acting_len = self.up_len.copy()


class OSDMapMapping:
    """Caches up/acting for every PG in the map (OSDMapMapping.h analog).

    ``update()`` recomputes all pools; ``get()`` answers from the cache.
    """

    def __init__(self, use_device: bool = True, device="cuda"):
        """``use_device`` maps through the candidate-table mapper on
        ``device`` ("cuda" unless the caller asks for the CPU, which runs
        the plain versions); False maps every pool on the host."""
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        self.pools: Dict[int, PoolMapping] = {}
        self.epoch = -1
        self.last_backend: Dict[int, str] = {}
        self.host_replayed: Dict[int, int] = {}
        # compiled-rule cache: the candidate tables are paid once per
        # crush-map change, not per epoch (up/out flips are the weights)
        self._rule_cache: Dict[Tuple[int, int, int], Tuple[bytes, object]] = {}

    @staticmethod
    def _crush_fingerprint(osdmap: OSDMap) -> bytes:
        import hashlib
        h = hashlib.sha1()
        m = osdmap.crush.crush
        for b in m.buckets:
            if b is None:
                h.update(b"-")
                continue
            h.update(np.asarray([b.id, b.alg, b.type], np.int64).tobytes())
            h.update(np.asarray(b.items, np.int64).tobytes())
            h.update(np.asarray(getattr(b, "item_weights", []),
                                np.int64).tobytes())
        for r in m.rules:
            if r is not None:
                for s in r.steps:
                    h.update(np.asarray([s.op, s.arg1, s.arg2],
                                        np.int64).tobytes())
        h.update(np.asarray([m.choose_total_tries, m.chooseleaf_vary_r,
                             m.chooseleaf_stable, m.chooseleaf_descend_once],
                            np.int64).tobytes())
        for key in sorted(m.choose_args):
            h.update(str(key).encode())
            for arg in m.choose_args[key]:
                if arg is None:
                    h.update(b"-")
                    continue
                h.update(np.asarray(arg.ids or [], np.int64).tobytes())
                for ws in arg.weight_set or []:
                    h.update(np.asarray(ws.weights, np.int64).tobytes())
        return h.digest()

    # ---- raw crush batch --------------------------------------------------
    def _raw_batch(self, osdmap: OSDMap, pool_id: int, pool: pg_pool_t,
                   pps: np.ndarray,
                   crush_fp: Optional[bytes] = None) -> np.ndarray:
        size = pool.size
        ruleno = osdmap.crush.find_rule(pool.crush_rule, pool.type, size)
        X = pps.shape[0]
        if ruleno < 0:
            return np.full((X, size), NONE, dtype=np.int32)
        weight = osdmap.osd_weight
        choose_args = osdmap.crush.crush.choose_args.get(pool_id)
        if self.use_device:
            key = (pool_id, ruleno, size)
            fp = crush_fp if crush_fp is not None \
                else self._crush_fingerprint(osdmap)
            cached = self._rule_cache.get(key)
            if cached is not None and cached[0] == fp:
                fr = cached[1]
            else:
                try:
                    fr = compile_fast_rule(osdmap.crush.crush, ruleno, size,
                                           choose_args, device=self.device)
                except ValueError:     # UnsupportedRule, compile_map's
                    fr = None
                self._rule_cache[key] = (fp, fr)
            if fr is not None:
                res, cnt = fr.map_batch(pps, weight)
                self.last_backend[pool_id] = (
                    "device" if self.device.type == "cuda" else "cpu")
                self.host_replayed[pool_id] = fr.host_replayed
                return self._trim(res, cnt, pool, size)
        out = np.full((X, size), NONE, dtype=np.int32)
        for i, x in enumerate(pps):
            res = crush_do_rule(osdmap.crush.crush, ruleno, int(x), size,
                                weight, choose_args)
            out[i, :len(res)] = res
        self.last_backend[pool_id] = "host"
        self.host_replayed[pool_id] = X
        return out

    @staticmethod
    def _trim(res: np.ndarray, cnt: np.ndarray, pool: pg_pool_t,
              size: int) -> np.ndarray:
        out = res[:, :size].copy()
        # mask slots beyond the per-row count
        cols = np.arange(size)[None, :]
        out[cols >= np.asarray(cnt)[:, None]] = NONE
        return out

    # ---- vectorized post-passes ------------------------------------------
    def _postprocess(self, osdmap: OSDMap, pool_id: int, pool: pg_pool_t,
                     raw: np.ndarray, pps: np.ndarray) -> PoolMapping:
        X, size = raw.shape
        state = np.asarray(osdmap.osd_state, dtype=np.int32)
        exists = (state & CEPH_OSD_EXISTS) != 0
        up_osd = (state & CEPH_OSD_UP) != 0

        def osd_flag(arr, flags):
            ok = (arr >= 0) & (arr < osdmap.max_osd)
            out = np.zeros(arr.shape, dtype=bool)
            out[ok] = flags[arr[ok]]
            return out

        valid = raw != NONE
        keep = valid & osd_flag(raw, exists)
        if pool.can_shift_osds():
            raw_f = _compact_rows(np.where(keep, raw, NONE))
        else:
            raw_f = np.where(keep, raw, NONE)
        # up filter
        upkeep = (raw_f != NONE) & osd_flag(raw_f, exists & up_osd)
        if pool.can_shift_osds():
            up = _compact_rows(np.where(upkeep, raw_f, NONE))
        else:
            up = np.where(upkeep, raw_f, NONE)
        up_primary = _first_valid(up)
        up, up_primary = self._affinity(osdmap, pool, up, up_primary, pps)
        pm = PoolMapping(up, up_primary, up.copy(), up_primary.copy(),
                         pool.can_shift_osds())

        # sparse exact overrides
        special = set()
        for d in (osdmap.pg_upmap, osdmap.pg_upmap_items, osdmap.pg_temp,
                  osdmap.primary_temp):
            for pg in d:
                if pg.pool == pool_id and pg.ps < X:
                    special.add(pg.ps)
        for ps in special:
            u, upri, act, apri = osdmap.pg_to_up_acting_osds(
                pg_t(pool_id, ps))
            pm.up[ps, :] = NONE
            pm.up[ps, :len(u)] = u
            pm.up_len[ps] = len(u)
            pm.up_primary[ps] = upri
            pm.acting[ps, :] = NONE
            pm.acting[ps, :len(act)] = act
            pm.acting_len[ps] = len(act)
            pm.acting_primary[ps] = apri
        return pm

    def _affinity(self, osdmap: OSDMap, pool: pg_pool_t, osds: np.ndarray,
                  primary: np.ndarray, pps: np.ndarray):
        """Vectorized _apply_primary_affinity (OSDMap.cc:2037-2090)."""
        aff_list = osdmap.osd_primary_affinity
        if aff_list is None:
            return osds, primary
        aff = np.asarray(aff_list, dtype=np.uint32)
        X, size = osds.shape
        valid = osds != NONE
        a = np.full(osds.shape, CEPH_OSD_DEFAULT_PRIMARY_AFFINITY,
                    dtype=np.uint32)
        ok = valid & (osds >= 0) & (osds < osdmap.max_osd)
        a[ok] = aff[osds[ok]]
        rows = np.any(ok & (a != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY), axis=1)
        if not rows.any():
            return osds, primary
        h = crush_hash32_2_np(pps[:, None].astype(np.uint32),
                              osds.astype(np.uint32)) >> np.uint32(16)
        rejected = valid & (a < CEPH_OSD_DEFAULT_PRIMARY_AFFINITY) & (h >= a)
        accepted = valid & ~rejected
        first_acc = _first_index(accepted)
        first_val = _first_index(valid)
        pos = np.where(first_acc >= 0, first_acc, first_val)
        use = rows & (pos >= 0)
        new_primary = primary.copy()
        new_primary[use] = osds[np.nonzero(use)[0], pos[use]]
        if pool.can_shift_osds():
            out = osds.copy()
            for i in np.nonzero(use & (pos > 0))[0]:
                p = pos[i]
                out[i, 1:p + 1] = osds[i, 0:p]
                out[i, 0] = osds[i, p]
            osds = out
        return osds, new_primary

    # ---- public -----------------------------------------------------------
    def update(self, osdmap: OSDMap) -> None:
        """Recompute all pools (the whole-map remap every epoch leans on)
        inside a ``crush_map_update`` span; the latency lands in the
        ``osdmap`` logger's ``crush_map_latency_histogram``."""
        t0 = time.perf_counter()
        with g_tracer.span("crush_map_update"):
            self.pools.clear()
            crush_fp = self._crush_fingerprint(osdmap) if self.use_device \
                else None
            for pool_id, pool in osdmap.pools.items():
                ps = np.arange(pool.pg_num, dtype=np.uint32)
                pps = pool_pps(pool, pool_id, ps)
                raw = self._raw_batch(osdmap, pool_id, pool, pps, crush_fp)
                self.pools[pool_id] = self._postprocess(
                    osdmap, pool_id, pool, raw, pps)
            self.epoch = osdmap.epoch
        g_perf_histograms.get(
            "osdmap", "crush_map_latency_histogram", latency_axes).inc(
            (time.perf_counter() - t0) * 1e6)

    def get(self, pg: pg_t) -> Tuple[List[int], int, List[int], int]:
        pm = self.pools[pg.pool]
        up = [int(o) for o in pm.up[pg.ps, :pm.up_len[pg.ps]]]
        acting = [int(o) for o in pm.acting[pg.ps, :pm.acting_len[pg.ps]]]
        return (up, int(pm.up_primary[pg.ps]),
                acting, int(pm.acting_primary[pg.ps]))

    def get_acting_row(self, pg: pg_t) -> List[int]:
        """Positional acting set (EC pools keep NONE holes)."""
        pm = self.pools[pg.pool]
        return [int(o) for o in pm.acting[pg.ps]]


def _compact_rows(arr: np.ndarray) -> np.ndarray:
    """Shift non-NONE entries left, preserving order (replicated pools)."""
    X, size = arr.shape
    out = np.full_like(arr, NONE)
    valid = arr != NONE
    pos = np.cumsum(valid, axis=1) - 1
    rows = np.broadcast_to(np.arange(X)[:, None], arr.shape)
    out[rows[valid], pos[valid]] = arr[valid]
    return out


def _first_valid(arr: np.ndarray) -> np.ndarray:
    """Primary pick: first non-NONE per row, else -1 (OSDMap.cc:1956)."""
    idx = _first_index(arr != NONE)
    out = np.full(arr.shape[0], -1, dtype=np.int32)
    ok = idx >= 0
    out[ok] = arr[np.nonzero(ok)[0], idx[ok]]
    return out


def _first_index(mask: np.ndarray) -> np.ndarray:
    """First True per row, -1 when none."""
    any_ = mask.any(axis=1)
    idx = mask.argmax(axis=1).astype(np.int64)
    idx[~any_] = -1
    return idx
