"""The port's OSDMap layer against the JAX package's, exactly.

- ``OSDMapMapping.update/get`` of the port (``device="cpu"``: the plain
  K7a/K7b) against the JAX one with ``use_device=True`` (its ``FastRule``,
  XLA on the CPU) and against both packages' scalar
  ``pg_to_up_acting_osds``, for a replicated and an EC pool, with down,
  out and reweighted OSDs, primary affinity, pg_temp, primary_temp,
  pg_upmap and pg_upmap_items, over epochs that mark OSDs out.  The JAX
  side compiles its rules once per module (module-scoped fixture).
- The scalar pipeline, ``map_to_pg``, incrementals, ``pool_pps`` and
  ``simple_build`` (``build_simple``, ``mark_up_in``, ``mark_out``,
  ``insert_item``) against the JAX package.
- The host route: ``use_device=False``, and a rule the card's mapper
  cannot compile (straw buckets) mapping on ``crush_do_rule``.

Tolerance: exact equality.
"""
import numpy as np
import pytest

import ceph_tpu.crush as jc
import ceph_tpu.osdmap as jo
import ceph_tpu_torch.crush as tc
import ceph_tpu_torch.osdmap as to
from ceph_tpu.osdmap import simple_build as jsb
from ceph_tpu_torch.osdmap import simple_build as tsb
from ceph_tpu_torch.utils import str_hash

PG_NUM = 256


def build_osdmap(pkg, crush, n_hosts=6, per_host=4, pg_num=PG_NUM):
    """Both pools of the OSDMap tests: replicated size 3 and EC size 6 on
    one straw2 map (``test_osdmap.build_osdmap``'s shape)."""
    m = pkg.OSDMap()
    m.epoch = 1
    n = n_hosts * per_host
    m.set_max_osd(n)
    cw = m.crush
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    host_ids = [cw.add_bucket(crush.CRUSH_BUCKET_STRAW2, 1, f"host{h}",
                              list(range(h * per_host, (h + 1) * per_host)),
                              [0x10000] * per_host, id=-(h + 2))
                for h in range(n_hosts)]
    cw.add_bucket(crush.CRUSH_BUCKET_STRAW2, 10, "default", host_ids,
                  [0x10000 * per_host] * n_hosts, id=-1)
    for i in range(n):
        m.set_osd(i, up=True)
    rep = cw.add_simple_rule("replicated_rule", "default", "host",
                             mode="firstn")
    ec = cw.add_simple_rule("ecrule", "default", "host", mode="indep",
                            rule_type=pkg.TYPE_ERASURE)
    cw.set_rule_mask_max_size(ec, 10)
    rp = m.add_pool("rbd", pkg.pg_pool_t(
        type=pkg.TYPE_REPLICATED, size=3, min_size=2, crush_rule=rep,
        pg_num=pg_num, pgp_num=pg_num))
    ep = m.add_pool("ec", pkg.pg_pool_t(
        type=pkg.TYPE_ERASURE, size=6, min_size=5, crush_rule=ec,
        pg_num=pg_num // 2, pgp_num=pg_num // 2))
    return m, (rp, ep), n


def sprinkle(pkg, m, pools, n):
    """Down, out, reweighted, affinity and every per-PG override."""
    rp, ep = pools
    m.set_osd(2, up=False)
    m.osd_weight[5] = 0
    m.osd_weight[9] = 0x8000
    m.set_primary_affinity(1, 0x4000)
    m.set_primary_affinity(13, 0)
    m.pg_temp[pkg.pg_t(rp, 3)] = [15, 16, 17]
    m.primary_temp[pkg.pg_t(rp, 7)] = 11
    m.pg_upmap_items[pkg.pg_t(rp, 11)] = [(0, 19)]
    m.pg_upmap[pkg.pg_t(rp, 12)] = [4, 8, 20]
    m.pg_temp[pkg.pg_t(ep, 4)] = [0, 4, 8, 12, 16, 20]


@pytest.fixture(scope="module")
def jax_mapping():
    """The JAX OSDMapMapping on its FastRule, compiled once."""
    return jo.OSDMapMapping(use_device=True)


def assert_same(pm, jm, pmap, jmap, pools):
    for pid in pools:
        for ps in range(pmap.pools[pid].pg_num):
            got = pm.get(to.pg_t(pid, ps))
            want = jm.get(jo.pg_t(pid, ps))
            assert got == want, (pid, ps, got, want)
            assert got == pmap.pg_to_up_acting_osds(to.pg_t(pid, ps)), \
                (pid, ps)
            assert pm.get_acting_row(to.pg_t(pid, ps)) == \
                jm.get_acting_row(jo.pg_t(pid, ps))


def test_mapping_matches_jax_over_epochs(jax_mapping):
    pmap, pools, n = build_osdmap(to, tc)
    jmap, jpools, _ = build_osdmap(jo, jc)
    assert pools == jpools
    sprinkle(to, pmap, pools, n)
    sprinkle(jo, jmap, pools, n)
    pm = to.OSDMapMapping(device="cpu")
    for epoch in range(4):
        if epoch:
            osd = (7 * epoch + 3) % n
            tsb.mark_out(pmap, osd)
            jsb.mark_out(jmap, osd)
            pmap.epoch = jmap.epoch = epoch + 1
        pm.update(pmap)
        jax_mapping.update(jmap)
        assert pm.epoch == jax_mapping.epoch == epoch + 1
        assert_same(pm, jax_mapping, pmap, jmap, pools)
        assert pm.last_backend == {pools[0]: "cpu", pools[1]: "cpu"}
        assert jax_mapping.last_backend == {pools[0]: "device",
                                            pools[1]: "device"}
    # one compiled rule per pool, reused across the epochs
    assert len(pm._rule_cache) == 2


def test_host_route_agrees():
    """use_device=False maps every pool on crush_do_rule."""
    pmap, pools, n = build_osdmap(to, tc, pg_num=64)
    sprinkle(to, pmap, pools, n)
    dev = to.OSDMapMapping(device="cpu")
    host = to.OSDMapMapping(use_device=False)
    dev.update(pmap)
    host.update(pmap)
    for pid in pools:
        for ps in range(pmap.pools[pid].pg_num):
            pg = to.pg_t(pid, ps)
            assert dev.get(pg) == host.get(pg) == \
                pmap.pg_to_up_acting_osds(pg)
    assert set(host.last_backend.values()) == {"host"}


def test_uncompilable_rule_maps_on_the_host():
    """A straw(v1) map is out of the card mapper's scope: compile_map's
    ValueError, raised before any launch, routes the pool to the host."""
    maps = []
    for pkg, crush in ((to, tc), (jo, jc)):
        m = pkg.OSDMap()
        m.set_max_osd(8)
        cw = m.crush
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts = [cw.add_bucket(crush.CRUSH_BUCKET_STRAW, 1, f"h{h}",
                               [2 * h, 2 * h + 1], [0x10000] * 2,
                               id=-(h + 2)) for h in range(4)]
        cw.add_bucket(crush.CRUSH_BUCKET_STRAW, 10, "default", hosts,
                      [0x20000] * 4, id=-1)
        for i in range(8):
            m.set_osd(i, up=True)
        rno = cw.add_simple_rule("r", "default", "host", mode="firstn")
        pid = m.add_pool("p", pkg.pg_pool_t(
            type=pkg.TYPE_REPLICATED, size=3, min_size=2, crush_rule=rno,
            pg_num=32, pgp_num=32))
        maps.append((m, pid))
    (pmap, pid), (jmap, _) = maps
    pm = to.OSDMapMapping(device="cpu")
    pm.update(pmap)
    jm = jo.OSDMapMapping(use_device=False, use_native=False)
    jm.update(jmap)
    assert pm.last_backend[pid] == "host"
    for ps in range(32):
        assert pm.get(to.pg_t(pid, ps)) == jm.get(jo.pg_t(pid, ps))


def test_scalar_pipeline_and_pps_match_jax():
    pmap, pools, n = build_osdmap(to, tc)
    jmap, _, _ = build_osdmap(jo, jc)
    sprinkle(to, pmap, pools, n)
    sprinkle(jo, jmap, pools, n)
    for pid in pools:
        pool, jpool = pmap.pools[pid], jmap.pools[pid]
        ps = np.arange(pool.pg_num, dtype=np.uint32)
        np.testing.assert_array_equal(to.pool_pps(pool, pid, ps),
                                      jo.pool_pps(jpool, pid, ps))
        for p in range(pool.pg_num):
            assert pmap.pg_to_up_acting_osds(to.pg_t(pid, p)) == \
                jmap.pg_to_up_acting_osds(jo.pg_t(pid, p))
            assert pmap.pg_to_raw_osds(to.pg_t(pid, p)) == \
                jmap.pg_to_raw_osds(jo.pg_t(pid, p))
    for name, ns in (("foo", ""), ("foo", "ns"), ("rbd_data.1234", "")):
        assert pmap.map_to_pg(pools[0], name, nspace=ns) == \
            to.pg_t(*[getattr(jmap.map_to_pg(pools[0], name, nspace=ns), f)
                      for f in ("pool", "ps")])
    from ceph_tpu.utils import str_hash as jstr
    for s in (b"", b"a", b"foo", b"rbd_data.1234.0000000000000001" * 3):
        assert str_hash.ceph_str_hash_rjenkins(s) == \
            jstr.ceph_str_hash_rjenkins(s)
        assert str_hash.ceph_str_hash_linux(s) == \
            jstr.ceph_str_hash_linux(s)


def test_incremental_matches_jax():
    out = []
    for pkg, crush in ((to, tc), (jo, jc)):
        m, pools, n = build_osdmap(pkg, crush, pg_num=64)
        inc = pkg.Incremental(epoch=2)
        inc.new_up[3] = False
        inc.new_weight[7] = 0
        m.apply_incremental(inc)
        inc2 = pkg.Incremental(epoch=3)
        inc2.new_pg_temp[pkg.pg_t(pools[0], 1)] = [2, 6, 10]
        m.apply_incremental(inc2)
        out.append((m.epoch, m.is_down(3), m.is_out(7),
                    [m.pg_to_up_acting_osds(pkg.pg_t(pools[0], p))
                     for p in range(64)]))
    assert out[0] == out[1]


def test_simple_build_matches_jax():
    """build_simple + mark_up_in + mark_out, and insert_item under a new
    host and rack, against the JAX package, through both mappings."""
    from test_torch_crush_host import state
    maps = []
    for pkg, sb in ((to, tsb), (jo, jsb)):
        m = sb.build_simple(12, pg_bits=3)
        sb.mark_up_in(m)
        sb.insert_item(m.crush, 12, 0x20000, "osd.12",
                       {"host": "h2", "rack": "r2", "root": "default"})
        m.set_max_osd(13)
        sb.mark_up_in(m)
        sb.mark_out(m, 4)
        maps.append(m)
    pmap, jmap = maps
    assert state(pmap.crush) == state(jmap.crush)
    assert pmap.osd_weight == jmap.osd_weight
    pm = to.OSDMapMapping(device="cpu")
    pm.update(pmap)
    jm = jo.OSDMapMapping(use_device=False, use_native=False)
    jm.update(jmap)
    for pid, pool in pmap.pools.items():
        for ps in range(pool.pg_num):
            assert pm.get(to.pg_t(pid, ps)) == jm.get(jo.pg_t(pid, ps))
