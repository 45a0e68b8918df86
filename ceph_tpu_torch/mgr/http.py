"""mgr HTTP frontends: the prometheus exporter endpoint and the
restful module's JSON API (pybind/mgr/prometheus/module.py serving
/metrics on its own port; pybind/mgr/restful/ read surface).

``MgrHttp.handle()`` is a pure (method, path) -> (status, headers,
body) function like the rgw frontend, so the routes are testable
without sockets; ``serve()`` wraps it in a threaded stdlib server.

Read surface (restful module's GET routes at lite scale):
  /metrics          prometheus text exposition
  /health           {"health": ..., "checks": {...}}
  /mon              monmap entries
  /osd              per-osd up/in/weight/stats
  /osd/<id>         one osd
  /pool             pools with pg/size/flags
  /pool/<id>        one pool
  /pg               pg summary by state
  /crush/rule       crush rules
  /server           the hosting daemon list (mon/mgr names)
  /request          the balancer's proposal history (the command-log
                    role; read-only here)

Port of ``ceph_tpu/mgr/http.py``; ``/metrics`` passes no breakers (the
port has none).
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple


class MgrHttp:
    def __init__(self, mgr, cluster=None, perf_collection=None):
        self.mgr = mgr
        self.cluster = cluster
        self.perf_collection = perf_collection

    # ---- route table -------------------------------------------------------
    def handle(self, method: str, path: str,
               headers: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               query: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Dict[str, str], bytes]:
        if method != "GET":
            return self._err(405, "method not allowed")
        parts = [p for p in path.split("/") if p]

        def one_id() -> Optional[int]:
            # the single <id> segment; None -> caller 400s
            try:
                return int(parts[1])
            except ValueError:
                return None

        if parts == ["metrics"]:
            from ..common import g_kernel_timer
            from ..trace import g_perf_histograms
            slow = {o.name: o.op_tracker.num_slow_ops
                    for o in self.cluster.osds.values()} \
                if self.cluster is not None else None
            self.mgr.check_degraded_codecs()
            text = self.mgr.prometheus_metrics(
                self.perf_collection, histograms=g_perf_histograms,
                kernel_timer=g_kernel_timer, slow_ops=slow)
            return 200, {"Content-Type":
                         "text/plain; version=0.0.4"}, text.encode()
        if not parts or parts == ["health"]:
            return self._json(self._health())
        if parts == ["mon"]:
            return self._json(self._mons())
        if parts == ["osd"]:
            return self._json(self._osds())
        if parts[0] == "osd" and len(parts) == 2:
            oid = one_id()
            if oid is None:
                return self._err(400, "bad id")
            want = [o for o in self._osds() if o["osd"] == oid]
            if not want:
                return self._err(404, "no such osd")
            return self._json(want[0])
        if parts == ["pool"]:
            return self._json(self._pools())
        if parts[0] == "pool" and len(parts) == 2:
            pid = one_id()
            if pid is None:
                return self._err(400, "bad id")
            want = [p for p in self._pools() if p["pool"] == pid]
            if not want:
                return self._err(404, "no such pool")
            return self._json(want[0])
        if parts == ["pg"]:
            return self._json(self._pgs())
        if parts == ["crush", "rule"]:
            return self._json(self._crush_rules())
        if parts == ["server"]:
            return self._json(self._servers())
        if parts == ["request"]:
            return self._json(self.mgr.proposal_log)
        return self._err(404, "unknown route")

    # ---- renderers ---------------------------------------------------------
    @staticmethod
    def _json(doc) -> Tuple[int, Dict[str, str], bytes]:
        return 200, {"Content-Type": "application/json"}, \
            (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()

    @staticmethod
    def _err(status: int, msg: str) -> Tuple[int, Dict[str, str],
                                             bytes]:
        return status, {"Content-Type": "application/json"}, \
            (json.dumps({"error": msg}) + "\n").encode()

    def _health(self):
        s = self.mgr.status()
        checks = dict(s["health_checks"])
        if self.cluster is not None:
            # the cluster-wide verdict carries its reason; surface it
            # machine-readably too so 'health' and 'checks' agree
            health = self.cluster.health()
            if health != "HEALTH_OK" and "CLUSTER" not in checks:
                checks["CLUSTER"] = health
        else:
            health = "HEALTH_OK" if not checks else "HEALTH_WARN"
        return {"health": health, "checks": checks,
                "epoch": s["epoch"]}

    def _mons(self):
        mon = self.mgr.mon
        mm = getattr(mon, "monmap", None)
        if mm is None:
            return [{"name": mon.name, "rank": 0}]
        return [{"name": n, "addr": a, "rank": r}
                for r, (n, a) in enumerate(mm.ranks())]

    def _osds(self):
        m = self.mgr.osdmap
        out = []
        for o in range(m.max_osd):
            if not m.exists(o):
                continue
            stats = self.mgr.osd_stats.get(o)
            ent = {"osd": o, "up": int(m.is_up(o)),
                   "in": int(m.osd_weight[o] > 0),
                   "weight": m.osd_weight[o] / 0x10000}
            if stats:
                ent["store_bytes"], ent["store_capacity"] = stats
            out.append(ent)
        return out

    def _pools(self):
        m = self.mgr.osdmap
        out = []
        for pid, pool in sorted(m.pools.items()):
            out.append({
                "pool": pid, "pool_name": m.pool_name.get(pid, ""),
                "type": "erasure" if pool.is_erasure()
                        else "replicated",
                "size": pool.size, "min_size": pool.min_size,
                "pg_num": pool.pg_num, "pgp_num": pool.pgp_num,
                "crush_rule": pool.crush_rule,
                "erasure_code_profile": pool.erasure_code_profile,
            })
        return out

    def _pgs(self):
        states = self.cluster.pg_states() \
            if self.cluster is not None else {}
        return {"pg_states": states,
                "num_pgs": sum(p.pg_num for p in
                               self.mgr.osdmap.pools.values())}

    def _crush_rules(self):
        cw = self.mgr.osdmap.crush
        out = []
        for i, r in enumerate(cw.crush.rules):
            if r is None:
                continue
            out.append({"rule_id": i,
                        "rule_name": cw.rule_name_map.get(i, f"rule{i}"),
                        "steps": len(r.steps)})
        return out

    def _servers(self):
        names = [self.mgr.name]
        mon = self.mgr.mon
        mm = getattr(mon, "monmap", None)
        if mm is not None:
            names += [n for n, _ in mm.ranks()]
        else:
            names.append(mon.name)
        return [{"hostname": n} for n in names]


def serve(frontend: MgrHttp, port: int = 0):
    """Threaded stdlib HTTP server; returns (server, port)."""
    from ..common.http_serve import serve_frontend
    return serve_frontend(frontend.handle, port)
