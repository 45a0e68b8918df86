"""The port's 32-slot limits, pinned against the JAX package.

The port's ``FastRule`` refuses a choose step of more than ``MAX_REP`` (32)
slots with ``UnsupportedRule("more than 32 slots")``, also with
``device="cpu"``, where the JAX ``compile_fast_rule`` maps the rule (K7b
keeps a step's slots in registers and K6 one slot per lane of a warp).
``OSDMapMapping`` and ``CrushTester`` send ``UnsupportedRule`` to the host
``crush_do_rule``, so the rows a user sees past 32 slots equal the JAX
package's.  Not pinned here, because they refuse on the card only:
``DeviceCrushMapper`` with result_max > 32 and ``LegacyFastRule`` with
buckets of more than 256 items or result_max > 32.

The map: 40 hosts of 2 OSDs, straw2, with ``add_simple_rule(...,
"firstn")`` (chooseleaf firstn 0 type host) at result_max / pool size 36.

Tolerance: exact equality.
"""
import io

import numpy as np
import pytest

import ceph_tpu.crush as jc
import ceph_tpu.osdmap as jo
import ceph_tpu_torch.crush as tc
import ceph_tpu_torch.osdmap as to
from ceph_tpu.crush.tester import CrushTester as JaxTester
from ceph_tpu_torch.crush.tester import CrushTester as PortTester
from ceph_tpu_torch.ops.crush_fast import UnsupportedRule, compile_fast_rule

from test_torch_crush_host import build_map, rule_of

WIDE = 36            # slots past MAX_REP
N_HOSTS, PER_HOST = 40, 2
N_X = 64


def wide_maps():
    """The 40 x 2 map through each package, with the wide firstn rule."""
    out = []
    for pkg in (jc, tc):
        cw, n = build_map(pkg, n_hosts=N_HOSTS, osds_per_host=PER_HOST)
        rno = cw.add_simple_rule("wide", "default", "host", mode="firstn")
        out.append((cw, rno, n))
    return out


def _steps(kind):
    T, E = tc.CRUSH_RULE_TAKE, tc.CRUSH_RULE_EMIT
    if kind == "indep":
        return [(T, -1, 0), (tc.CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1), (E, 0, 0)]
    # a middle step of 33 hosts, then one OSD in each
    return [(T, -1, 0), (tc.CRUSH_RULE_CHOOSE_FIRSTN, 33, 1),
            (tc.CRUSH_RULE_CHOOSE_FIRSTN, 1, 0), (E, 0, 0)]


@pytest.mark.parametrize("kind", ["firstn", "indep", "middle_step"])
def test_fast_rule_refuses_more_than_32_slots_on_cpu(kind):
    """The port refuses while the rule compiles, on the CPU too; the JAX
    host interpreter maps the same rule (its rows fill the wide slots)."""
    (rcw, rno, n), (pcw, prno, _) = wide_maps()
    if kind != "firstn":
        rno = rule_of(jc, rcw, _steps(kind), kind, 1, 50)
        prno = rule_of(tc, pcw, _steps(kind), kind, 1, 50)
    assert prno == rno
    with pytest.raises(UnsupportedRule, match="more than 32 slots"):
        compile_fast_rule(pcw.crush, prno, WIDE, device="cpu")
    w = [0x10000] * n
    rows = [rcw.do_rule(rno, x, WIDE, w) for x in range(8)]
    assert max(len(r) for r in rows) > 32
    assert rows == [pcw.do_rule(prno, x, WIDE, w) for x in range(8)]


def _wide_osdmap(pkg, crush):
    m = pkg.OSDMap()
    m.epoch = 1
    n = N_HOSTS * PER_HOST
    m.set_max_osd(n)
    cw = m.crush
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    hosts = [cw.add_bucket(crush.CRUSH_BUCKET_STRAW2, 1, f"host{h}",
                           list(range(h * PER_HOST, (h + 1) * PER_HOST)),
                           [0x10000] * PER_HOST, id=-(h + 2))
             for h in range(N_HOSTS)]
    cw.add_bucket(crush.CRUSH_BUCKET_STRAW2, 10, "default", hosts,
                  [0x10000 * PER_HOST] * N_HOSTS, id=-1)
    for i in range(n):
        m.set_osd(i, up=True)
    rule = cw.add_simple_rule("wide", "default", "host", mode="firstn")
    cw.set_rule_mask_max_size(rule, WIDE)
    pool = m.add_pool("wide", pkg.pg_pool_t(
        type=pkg.TYPE_REPLICATED, size=WIDE, min_size=2, crush_rule=rule,
        pg_num=N_X, pgp_num=N_X))
    return m, pool, n


def test_osdmap_rows_past_32_slots_match_jax():
    """A pool of size 36: the port maps it on the host route (the rule
    does not compile for the card's mapper) and every PG's up/acting row
    equals the JAX ``OSDMapMapping``'s, over an epoch that marks OSDs
    out."""
    from ceph_tpu.osdmap import simple_build as jsb
    from ceph_tpu_torch.osdmap import simple_build as tsb
    pmap, pool, n = _wide_osdmap(to, tc)
    jmap, jpool, _ = _wide_osdmap(jo, jc)
    assert pool == jpool
    pm = to.OSDMapMapping(device="cpu")
    jm = jo.OSDMapMapping(use_device=False)
    for epoch in range(2):
        if epoch:
            for osd in (3, 17, 42):
                tsb.mark_out(pmap, osd)
                jsb.mark_out(jmap, osd)
            pmap.epoch = jmap.epoch = epoch + 1
        pm.update(pmap)
        jm.update(jmap)
        assert pm.last_backend[pool] == "host"
        rows = [pm.get(to.pg_t(pool, ps)) for ps in range(N_X)]
        assert rows == [jm.get(jo.pg_t(pool, ps)) for ps in range(N_X)]
        assert max(len(r[0]) for r in rows) > 32


def test_crushtool_rows_past_32_slots_match_jax():
    """``crushtool --test --show-mappings --num-rep 36`` over x 0..63: the
    port's tester (host route past 32 slots) prints the JAX tester's text
    byte for byte."""
    (rcw, rno, _), (pcw, prno, _) = wide_maps()
    texts = []
    for cw, tester, kw in ((rcw, JaxTester, {}),
                           (pcw, PortTester, {"device": "cpu"})):
        out = io.StringIO()
        t = tester(cw, out, **kw)
        if tester is JaxTester:
            t.use_device = False
        t.set_rule(rno)
        t.set_num_rep(WIDE)
        t.set_max_x(N_X - 1)
        t.set_output_mappings(True)
        t.test()
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    lines = texts[1].splitlines()
    assert len(lines) == N_X
    assert max(len(line.split("[")[1].split(",")) for line in lines) > 32
    assert np.all([f"x {x} " in line for x, line in enumerate(lines)])
