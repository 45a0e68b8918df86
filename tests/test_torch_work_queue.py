"""The port's op queue against the JAX package's, on the CPU.

The same enqueue sequence through both packages' ``MClockQueue`` (class
tags: reservation, weight and limit), ``WallMClockQueue`` (on a stepped
clock), per-client ``ClientDmClock`` lanes, ``ShardedOpWQ`` and the
``DmClockArbiter`` core gives the same dequeue order.  Admission
throttling sheds the same ops of a burst on both packages' daemons.  The
port's ``ShardedThreadPool`` keeps a worker alive past a poisoned op.
"""
import threading

import numpy as np
import pytest

from ceph_tpu.common import work_queue as jwq
from ceph_tpu_torch.common import work_queue as pwq

from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import (JAX, PORT, boot, payloads,
                               set_both)


TAGS = [
    {pwq.CLASS_CLIENT: (0.0, 400.0, 0.0), pwq.CLASS_RECOVERY:
     (0.0, 100.0, 0.0)},
    {pwq.CLASS_CLIENT: (0.0, 1000.0, 0.0), pwq.CLASS_SCRUB:
     (100.0, 1.0, 0.0)},
    {pwq.CLASS_CLIENT: (0.0, 10.0, 0.0), pwq.CLASS_RECOVERY:
     (0.0, 1000.0, 20.0), pwq.CLASS_SNAPTRIM: (50.0, 5.0, 100.0)},
    None,                                          # the option defaults
]
CLASSES = (pwq.CLASS_CLIENT, pwq.CLASS_RECOVERY, pwq.CLASS_SCRUB,
           pwq.CLASS_SNAPTRIM)


def _sequence(seed, n=400, clients=("client.a", "client.b", "")):
    rng = np.random.default_rng(seed)
    return [(CLASSES[int(rng.integers(0, 4))],
             clients[int(rng.integers(0, len(clients)))], i)
            for i in range(n)]


def _interleaved_order(q, seq, pop):
    """Enqueue in bursts, popping between them, then drain."""
    out = []
    for j, (cls, client, i) in enumerate(seq):
        q.enqueue(cls, (cls, client, i), client=client)
        if j % 7 == 6:
            out.append(pop(q))
    while len(q):
        out.append(pop(q))
    return out


@pytest.mark.parametrize("tags", range(len(TAGS)))
def test_mclock_dequeue_order_matches_jax(clean, tags):
    seq = _sequence(tags)
    got = _interleaved_order(pwq.MClockQueue(TAGS[tags]), seq,
                             lambda q: q.dequeue())
    want = _interleaved_order(jwq.MClockQueue(TAGS[tags]), seq,
                              lambda q: q.dequeue())
    assert got == want
    assert len(got) == len(seq)


@pytest.mark.parametrize("tags", range(len(TAGS)))
def test_wall_mclock_dequeue_order_matches_jax(clean, tags):
    """Wall-rate tags on a clock that steps 1 ms per read: the same
    items come out at the same steps, and the same refusals
    (``(None, next_due)``) fall between them."""
    seq = _sequence(100 + tags, n=200)

    def order(mod):
        t = [0.0]

        def clock():
            t[0] += 0.001
            return t[0]
        q = mod.WallMClockQueue(TAGS[tags], clock=clock)
        out = []
        for j, (cls, client, i) in enumerate(seq):
            q.enqueue(cls, (cls, client, i), client=client)
            if j % 5 == 4:
                out.append(q.dequeue())
        for _ in range(2000):
            if not len(q):
                break
            out.append(q.dequeue())
        return out, len(q)
    assert order(pwq) == order(jwq)


def test_client_lanes_match_jax(clean):
    """dmClock client lanes with per-client tags and the override
    option: the same pop order."""
    def order(mod):
        lanes = mod.ClientDmClock()
        lanes.set_client_tags("client.gold", 200.0, 10.0, 0.0)
        lanes.set_client_tags("client.capped", 0.0, 100.0, 50.0)
        out = []
        rng = np.random.default_rng(3)
        for i in range(300):
            c = ("client.gold", "client.capped", "client.x", "")[
                int(rng.integers(0, 4))]
            lanes.push(c, (c, i))
            if i % 3 == 2:
                out.append(lanes.pop())
        while len(lanes):
            out.append(lanes.pop())
        return out
    set_both("osd_mclock_client_overrides", "client.x:5:2:40")
    assert order(pwq) == order(jwq)


def test_arbiter_core_matches_jax(clean):
    def picks(mod):
        arb = mod.DmClockArbiter(track_floor=True)
        tags = {"a": (10.0, 5.0, 0.0), "b": (0.0, 20.0, 300.0),
                "c": (50.0, 1.0, 100.0)}
        active = []
        for e, (r, w, _lim) in tags.items():
            arb.activate(e, r, w, list(active), lambda x: tags[x][1])
            active.append(e)
        out = []
        for _ in range(200):
            arb.tick()
            e = arb.pick(active, tags)
            arb.serve(e, tags[e][1])
            out.append(e)
        return out
    assert picks(pwq) == picks(jwq)


def test_sharded_wq_drain_order_matches_jax(clean):
    def order(mod):
        wq = mod.ShardedOpWQ(n_shards=4)
        for cls, client, i in _sequence(7, n=120):
            wq.enqueue((1, i % 9), cls, (cls, client, i), client=client)
        seen = []
        wq.drain(seen.append)
        return seen
    got = order(pwq)
    assert got == order(jwq) and len(got) == 120


def test_admission_sheds_what_jax_sheds(clean):
    """Burst intake with a queue cap of 4: the OSDs shed the same ops of
    one burst with EAGAIN on both packages' daemons."""
    set_both("osd_op_queue_batch_intake", True)
    set_both("osd_op_queue_admission_max", 4)
    objs = payloads(24, seed=9, base=3000, step=10)
    res = {}
    for pkg in (JAX, PORT):
        d, cl = boot(pkg)
        res[pkg] = d.burst_write_full(cl, "ecpool", objs)
        d.shutdown()
    assert res[JAX] == res[PORT]
    assert -11 in res[PORT].values() and 0 in res[PORT].values()


def test_poisoned_op_does_not_kill_its_worker(clean, capsys):
    """A handler that raises on one op leaves its worker thread alive:
    the ops behind it on the same shard are still handled."""
    wq = pwq.ShardedOpWQ(n_shards=2)
    seen = []
    lock = threading.Lock()

    def handler(item):
        if item == "poison":
            raise RuntimeError("poisoned op")
        with lock:
            seen.append(item)
    pool = pwq.ShardedThreadPool(wq, handler, n_threads=2)
    try:
        wq.enqueue((0, 0), pwq.CLASS_CLIENT, "poison")
        for i in range(10):
            wq.enqueue((0, 0), pwq.CLASS_CLIENT, i)
        pool.kick()
        pool.flush(timeout=10.0)
    finally:
        pool.stop()
    assert seen == list(range(10))
    assert "poisoned op" in capsys.readouterr().err
