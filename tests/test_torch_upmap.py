"""The port's upmap optimizer, balancer and rule re-mapper against the
JAX package's, on the CPU.

Both packages build the same maps with their own ``simple_build``: a
conf map of 3 racks x 4 hosts x 4 OSDs (``build_from_conf``, the
layout of the reference's ``ceph.conf.withracks`` at a small size),
the same map with one OSD marked out, and the same map carrying
``pg_upmap_items`` before the optimizer runs (some of them landing on
overfull OSDs, so the optimizer's removal path runs).  On each:

- ``crush.remap.get_rule_weight_osd_map`` and ``try_remap_rule`` on
  sampled pgs with the optimizer's overfull / underfull sets;
- ``osdmap.upmap.calc_pg_upmaps`` on the port's native route and on its
  host route (``host_mapper=True``), each against the JAX one: the
  returned count, the ``PendingInc`` contents in insertion order and the
  map's ``pg_upmap_items`` after the run;
- ``osdmap.balancer.calc_pg_upmaps`` (the mgr's entry point, over an
  ``Incremental``) the same way;
- ``osdmap.balancer.calc_weight_set`` (the crush-compat mode): the two
  stddevs and every installed weight set.

Tolerance: exact equality (the optimizer's float32 arithmetic included).
"""
import numpy as np
import pytest

from ceph_tpu.crush import remap as jremap
from ceph_tpu.osdmap import balancer as jbal
from ceph_tpu.osdmap import osdmap as josdmap
from ceph_tpu.osdmap import simple_build as jsb
from ceph_tpu.osdmap import upmap as jup
from ceph_tpu.osdmap.types import pg_t as jpg_t

from ceph_tpu_torch.crush import remap as tremap
from ceph_tpu_torch.osdmap import balancer as tbal
from ceph_tpu_torch.osdmap import osdmap as tosdmap
from ceph_tpu_torch.osdmap import simple_build as tsb
from ceph_tpu_torch.osdmap import upmap as tup
from ceph_tpu_torch.osdmap.types import pg_t as tpg_t

RACKS, HOSTS, PER_HOST = 3, 4, 4
PG_BITS = 3                      # pg_num = 48 << 3 = 384


def rack_conf(racks=RACKS, hosts=HOSTS, per_host=PER_HOST) -> str:
    """A ceph.conf of ``[osd.N]`` sections with host and rack keys."""
    lines = []
    osd = 0
    for r in range(racks):
        for h in range(hosts):
            for _ in range(per_host):
                lines += [f"[osd.{osd}]", f"\thost = rack{r}host{h}",
                          f"\track = rack{r}", ""]
                osd += 1
    return "\n".join(lines)


PKGS = {"jax": (jsb, jpg_t), "torch": (tsb, tpg_t)}


def build(pkg, case):
    sb, pg_t = PKGS[pkg]
    m = sb.build_from_conf(rack_conf(), with_default_pool=True,
                           pg_bits=PG_BITS, pgp_bits=PG_BITS)
    sb.mark_up_in(m)
    if case in ("out", "items"):
        sb.mark_out(m, 7)
    if case == "items":
        # osd 5's host mates take pgs of other hosts (the optimizer
        # drops these where they land on an overfull osd), plus one
        # entry that moves a pg onto an osd that is not overfull
        m.pg_upmap_items[pg_t(1, 3)] = [(m.pg_to_raw_up(pg_t(1, 3))[0][0],
                                         4)]
        m.pg_upmap_items[pg_t(1, 10)] = [(m.pg_to_raw_up(
            pg_t(1, 10))[0][1], 5)]
        m.pg_upmap_items[pg_t(1, 77)] = [(m.pg_to_raw_up(
            pg_t(1, 77))[0][2], 6)]
    return m


def items(d):
    """pg_upmap_items-like dict -> [(pool, ps, pairs)] in its order."""
    return [(pg.pool, pg.ps, [tuple(p) for p in v]) for pg, v in d.items()]


CASES = ("conf", "out", "items")


@pytest.mark.parametrize("case", CASES)
def test_rule_weight_osd_map(case):
    jm, tm = build("jax", case), build("torch", case)
    for rno in range(len(jm.crush.crush.rules)):
        if jm.crush.crush.rules[rno] is None:
            continue
        assert tremap.get_rule_weight_osd_map(tm.crush, rno) == \
            jremap.get_rule_weight_osd_map(jm.crush, rno)


@pytest.mark.parametrize("case", CASES)
def test_try_remap_rule(case):
    """try_remap_rule on 64 pgs with overfull / underfull sets drawn from
    a seeded rng (the optimizer's own sets are exercised below)."""
    jm, tm = build("jax", case), build("torch", case)
    rng = np.random.default_rng(11)
    pool = jm.pools[1]
    rule = jm.crush.find_rule(pool.crush_rule, pool.type, pool.size)
    n_osd = jm.max_osd
    moved = 0
    for ps in rng.choice(pool.pg_num, 64, replace=False):
        raw, _ = jm.pg_to_raw_up(jpg_t(1, int(ps)))
        assert tm.pg_to_raw_up(tpg_t(1, int(ps)))[0] == raw
        overfull = set(int(o) for o in rng.choice(n_osd, 8, replace=False))
        overfull.add(raw[int(rng.integers(len(raw)))])
        underfull = [int(o) for o in rng.permutation(n_osd)
                     if int(o) not in overfull][:12]
        want = jremap.try_remap_rule(jm.crush, rule, pool.size, overfull,
                                     underfull, list(raw))
        got = tremap.try_remap_rule(tm.crush, rule, pool.size, overfull,
                                    underfull, list(raw))
        assert got == want
        moved += want is not None and want != raw
    assert moved > 0


def _jax_upmap(case, dev, max_changes):
    jm = build("jax", case)
    jinc = jup.PendingInc()
    n = jup.calc_pg_upmaps(jm, dev, max_changes, None, jinc)
    return jm, jinc, n


@pytest.mark.parametrize("host_mapper", [False, True],
                         ids=["native", "host"])
@pytest.mark.parametrize("case,dev,max_changes", [
    ("conf", 0.01, 100), ("out", 0.01, 100), ("out", 0.05, 7),
    ("items", 0.01, 100)])
def test_calc_pg_upmaps(case, dev, max_changes, host_mapper):
    jm, jinc, jn = _jax_upmap(case, dev, max_changes)
    tm = build("torch", case)
    tinc = tup.PendingInc()
    tn = tup.calc_pg_upmaps(tm, dev, max_changes, None, tinc,
                            host_mapper=host_mapper)
    assert tn == jn
    assert jn > 0
    assert items(tinc.new_pg_upmap_items) == items(jinc.new_pg_upmap_items)
    assert sorted((pg.pool, pg.ps) for pg in tinc.old_pg_upmap_items) == \
        sorted((pg.pool, pg.ps) for pg in jinc.old_pg_upmap_items)
    assert items(tm.pg_upmap_items) == items(jm.pg_upmap_items)
    if case == "items":
        assert jinc.old_pg_upmap_items       # the removal path ran


def test_calc_pg_upmaps_only_pools_and_raw_all():
    """A pool filter that names the pool, and ``_raw_all`` on both routes
    equal to the JAX rows."""
    jm, tm = build("jax", "out"), build("torch", "out")
    jrows = jup._raw_all(jm, 1, jm.pools[1])
    assert tup._raw_all(tm, 1, tm.pools[1]) == jrows
    assert tup._raw_all(tm, 1, tm.pools[1], host_mapper=True) == jrows
    jinc, tinc = jup.PendingInc(), tup.PendingInc()
    assert tup.calc_pg_upmaps(tm, 0.02, 20, {1}, tinc) == \
        jup.calc_pg_upmaps(jm, 0.02, 20, {1}, jinc)
    assert items(tinc.new_pg_upmap_items) == items(jinc.new_pg_upmap_items)


@pytest.mark.parametrize("case", CASES)
def test_balancer_calc_pg_upmaps(case):
    jm, tm = build("jax", case), build("torch", case)
    jinc, tinc = josdmap.Incremental(epoch=2), tosdmap.Incremental(epoch=2)
    jn = jbal.calc_pg_upmaps(jm, max_deviation=0.01, max_iterations=50,
                             inc=jinc)
    tn = tbal.calc_pg_upmaps(tm, max_deviation=0.01, max_iterations=50,
                             inc=tinc)
    assert tn == jn > 0
    assert items(tinc.new_pg_upmap_items) == items(jinc.new_pg_upmap_items)
    assert [(pg.pool, pg.ps) for pg in tinc.old_pg_upmap_items] == \
        [(pg.pool, pg.ps) for pg in jinc.old_pg_upmap_items]
    assert items(tm.pg_upmap_items) == items(jm.pg_upmap_items)


def _weight_sets(m, pool_id):
    return [None if a is None else
            [list(ws.weights) for ws in (a.weight_set or [])]
            for a in m.crush.crush.choose_args[pool_id]]


@pytest.mark.parametrize("case,iters", [("conf", 6), ("out", 4)])
def test_calc_weight_set(case, iters):
    jm, tm = build("jax", case), build("torch", case)
    jr = jbal.calc_weight_set(jm, 1, max_iterations=iters)
    tr = tbal.calc_weight_set(tm, 1, max_iterations=iters)
    assert tr == jr
    assert _weight_sets(tm, 1) == _weight_sets(jm, 1)
    # the installed weight set maps the pool alike in both packages
    for ps in range(0, tm.pools[1].pg_num, 7):
        assert tm.pg_to_raw_up(tpg_t(1, ps)) == jm.pg_to_raw_up(
            jpg_t(1, ps))
