"""A reply slower than the client's reply window, in both packages.

``RadosClient._submit_attempts`` sends an op, pumps the fabric until it
is quiet, and on no reply refreshes the map and resends, ``MAX_ATTEMPTS``
times; the port carries the JAX loop unchanged.  Across processes an op
whose reply comes after the pump went quiet (50 ms on the TCP
messenger) is answered -110 though the OSD applied it.  Here the same
stub fabric holds every ``MOSDOpReply`` to the client until the call has
returned, on both packages' in-process daemons (``chip_smoke.Daemons``):
both answer -110 after the same 8 attempts, the write is applied, and
the late replies, released afterwards, land under tids nobody waits for.
"""
import numpy as np
import pytest

from torch_daemon_twin import JAX, PORT, boot, clean  # noqa: F401


class HoldReplies:
    """The stub fabric's hook: while ``on``, every op reply to the client
    is taken off the wire and kept; ``release`` puts them back."""

    def __init__(self, network, client_name):
        self.network = network
        self.client = client_name
        self.on = False
        self.held = []
        self.ops_sent = 0

    def __call__(self, src, dst, msg):
        kind = type(msg).__name__
        if kind == "MOSDOp" and src == self.client and self.on:
            self.ops_sent += 1
        if self.on and dst == self.client and kind == "MOSDOpReply":
            self.held.append((src, dst, msg))
            return True
        return False

    def release(self):
        self.on = False
        for item in self.held:
            self.network.queue.append(item)
        self.held = []
        self.network.pump()


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_slow_reply_answers_timeout_after_eight_attempts(clean, pkg):
    d, cl = boot(pkg, n_osds=6, pg_num=8)
    body = np.random.default_rng(5).integers(0, 256, 12000,
                                             dtype=np.uint8).tobytes()
    hold = HoldReplies(d.network, cl.name)
    d.network.drop_hook = hold
    hold.on = True
    rc = cl.write_full("ecpool", "slow", body)
    sent = hold.ops_sent
    late = {m.tid: m.result for _s, _d, m in hold.held}
    hold.release()
    assert rc == -110
    assert sent == 8                 # MAX_ATTEMPTS sends, one per attempt
    assert len(late) == 8            # every attempt was answered, late
    assert set(late.values()) == {0}
    # released, the late replies sit under tids no call waits for
    assert set(late) <= set(cl._replies)
    # the write was applied: a read with the fabric back to normal
    assert cl.read("ecpool", "slow") == body


def test_both_packages_give_the_same_attempts(clean):
    from ceph_tpu.client import rados as jax_rados
    from ceph_tpu_torch.client import rados as port_rados
    assert port_rados.MAX_ATTEMPTS == jax_rados.MAX_ATTEMPTS == 8
