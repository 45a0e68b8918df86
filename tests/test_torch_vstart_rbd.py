"""rbd over the port's process cluster, on the CPU: ``tests/
test_vstart_rbd.py``'s case on ``ProcessCluster(device="cpu")``.

Each OSD process loads the object classes at start
(``osd/cls.load_builtin_classes``: ``rbd`` and ``journal`` since the
rbd slice), so ``cls_rbd`` calls that arrive over TCP run in the port's
OSD as they do in the JAX package's: create, write, read, snapshot,
list and the advisory lock, with the answers the JAX case asserts.
"""
import time

from ceph_tpu_torch.vstart import ProcessCluster


def test_rbd_image_over_process_cluster():
    c = ProcessCluster(
        n_osds=3,
        pool={"name": "rbd", "type": "replicated", "size": 2,
              "pg_num": 8},
        heartbeat_interval=1.0, heartbeat_grace=4.0, device="cpu")
    try:
        cl = c.client("client.x")
        c.wait_healthy(cl)       # map delivery + peering (loaded host)
        from ceph_tpu_torch.rbd import Image, RBD
        rbd = RBD(cl)
        # short retry only for daemons still applying their first maps
        last = None
        for attempt in range(30):
            try:
                rbd.create("rbd", "disk", 1 << 14, order=12)
                break
            except Exception as e:
                last = e
                cl.mon.send_full_map(cl.name)
                cl.network.pump(deadline=0.3)
                time.sleep(0.5)
        else:
            raise last
        img = Image(cl, "rbd", "disk")
        img.write(0, b"over-the-wire")
        assert img.read(0, 13) == b"over-the-wire"
        img.snap_create("s1")
        img.write(0, b"after-snap!!!")
        assert Image(cl, "rbd", "disk", snapshot="s1").read(0, 13) == \
            b"over-the-wire"
        assert rbd.list("rbd") == ["disk"]
        # advisory lock round-trips over TCP too
        assert img.lock_exclusive("c1") == 0
        assert img.list_lockers()[0]["cookie"] == "c1"
        assert img.unlock("c1") == 0
        # the header's class answered in an OSD process of the port
        ret, out = cl.exec("rbd", "rbd_header." + img.id, "rbd",
                           "get_image")
        assert ret == 0 and b'"size": 16384' in out
    finally:
        c.close()
