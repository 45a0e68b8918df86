"""The port's device-resident EC write (fused encode + body layout +
crc32c) and its DeviceShard budget, on the CPU.

Port side: ``ceph_tpu_torch.ops.resident.encode_resident_shards`` with a
``backend=host`` codec (the plain versions of the bit-matmul and crc32c
kernels on the CPU) and ``ceph_tpu_torch.os_store.device_shard``.
Reference side: ``ceph_tpu.ops.resident.encode_resident_shards`` with
the ``tpu`` plugin (its XLA device path on the CPU).  Inputs are seeded
numpy bytes; the tolerance is exact: bodies and CRCs are integers.
"""
import gc

import numpy as np
import pytest
import torch

from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu.ops.resident import encode_resident_shards as jax_resident

from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.ec import create_erasure_code as port_create
from ceph_tpu_torch.ops import crc32c_device, resident
from ceph_tpu_torch.os_store.device_shard import (
    DeviceShard, g_device_budget, memstore_device_perf_counters)
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.utils.crc32c import crc32c

TECHS = ["reed_sol_van", "cauchy"]


@pytest.fixture(autouse=True)
def _budget():
    """No residency limit unless a test sets one, and a drained LRU
    afterwards, so tests never see each other's resident bytes."""
    saved = g_conf.values.get("os_memstore_device_bytes_max")
    g_conf.rm_val("os_memstore_device_bytes_max")
    yield
    if saved is None:
        g_conf.rm_val("os_memstore_device_bytes_max")
    else:
        g_conf.set_val("os_memstore_device_bytes_max", saved)
    gc.collect()


def _port(k, m, tech="reed_sol_van", **extra):
    return port_create({"plugin": "cuda", "backend": "host", "k": str(k),
                        "m": str(m), "technique": tech, **extra})


def _jax(k, m, tech="reed_sol_van"):
    return jax_create({"plugin": "tpu", "k": str(k), "m": str(m),
                       "technique": tech})


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("k,m,s,c", [(3, 2, 4, 100), (8, 4, 3, 4096),
                                     (8, 4, 2, 5000)])
def test_resident_matches_jax(k, m, s, c, tech):
    """Bodies and CRCs byte-equal to the JAX fused encode, to the host
    CRC of each body and to a HashInfo of the host ECUtil shards."""
    stripes = np.random.default_rng(k * 100 + s).integers(
        0, 256, (s, k, c), dtype=np.uint8)
    got = resident.encode_resident_shards(_port(k, m, tech), stripes)
    want = jax_resident(_jax(k, m, tech), stripes)
    assert sorted(got) == sorted(want) == list(range(k + m))
    hinfo = ecutil.HashInfo(k + m)
    shards = ecutil.encode(ecutil.stripe_info_t(k, k * c), _port(k, m, tech),
                           stripes.reshape(-1), set(range(k + m)))
    hinfo.append(0, shards)
    for i in range(k + m):
        body = got[i].device_array()
        assert body.device.type == "cpu" and got[i].length == s * c
        np.testing.assert_array_equal(body.numpy(),
                                      np.asarray(want[i].device_array()))
        np.testing.assert_array_equal(body.numpy(), shards[i])
        assert got[i].crc == want[i].crc == crc32c(shards[i])
        assert got[i].crc == hinfo.get_chunk_hash(i)
        assert crc32c_device.crc32c_of_device_array(body) == got[i].crc


def test_resident_takes_a_tensor_and_counts_no_cpu_launch():
    k, m = 4, 2
    stripes = np.random.default_rng(1).integers(0, 256, (5, k, 64), np.uint8)
    before = resident.launches.n
    a = resident.encode_resident_shards(_port(k, m), stripes)
    b = resident.encode_resident_shards(_port(k, m),
                                        torch.from_numpy(stripes))
    assert resident.launches.n == before          # plain versions only
    for i in range(k + m):
        assert a[i].crc == b[i].crc
        assert torch.equal(a[i].device_array(), b[i].device_array())


def test_each_body_owns_its_storage():
    """Every body is its own allocation of exactly its bytes, so the
    budget's count is what a released shard frees."""
    sh = resident.encode_resident_shards(
        _port(4, 2), np.zeros((3, 4, 32), np.uint8))
    ptrs = set()
    for d in sh.values():
        st = d.device_array().untyped_storage()
        assert st.nbytes() == d.length == 96
        ptrs.add(st.data_ptr())
    assert len(ptrs) == 6


def test_resident_capable_gates():
    assert resident.resident_capable(_port(4, 2))
    mapped = port_create({"plugin": "isa", "backend": "host", "k": "4",
                          "m": "2", "mapping": "DD__DD"})
    assert not resident.resident_capable(mapped)
    assert resident.encode_resident_shards(
        mapped, np.zeros((1, 4, 32), np.uint8)) is None
    with pytest.raises(ValueError):
        resident.encode_resident_shards(
            _port(4, 2), torch.zeros((1, 4, 32), dtype=torch.int16))


# ---- DeviceShard and its budget --------------------------------------------
def _shard(n: int, seed: int) -> DeviceShard:
    data = np.random.default_rng(seed).integers(0, 256, n, np.uint8)
    return DeviceShard(torch.from_numpy(data.copy()), n, crc32c(data))


def _payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def test_materialize_once_then_free():
    sh = _shard(4096, 1)
    assert sh.is_resident and len(sh) == 4096
    before = memstore_device_perf_counters().dump()["materializations"]
    assert sh.materialize() == _payload(4096, 1)
    assert bytes(sh) == _payload(4096, 1)            # later calls are free
    after = memstore_device_perf_counters().dump()["materializations"]
    assert after == before + 1
    assert not sh.is_resident and sh.device_array() is None


def test_counter_names_match_jax():
    assert sorted(memstore_device_perf_counters().dump()) == sorted(
        ["resident_bytes", "resident_shards", "materializations",
         "demotions", "crc_device", "crc_host"])


def test_lru_demotes_coldest_over_budget():
    g_conf.set_val("os_memstore_device_bytes_max", 100)
    before = memstore_device_perf_counters().dump()["demotions"]
    old = _shard(64, 3)
    new = _shard(64, 4)                              # 128 > 100
    assert not old.is_resident and new.is_resident
    assert old.materialize() == _payload(64, 3)
    assert memstore_device_perf_counters().dump()["demotions"] == before + 1


def test_touch_refreshes_lru_order():
    g_conf.set_val("os_memstore_device_bytes_max", 150)
    a, b = _shard(64, 5), _shard(64, 6)
    g_device_budget.touch(a)
    c = _shard(64, 7)
    assert a.is_resident and c.is_resident and not b.is_resident


def test_dropped_shard_is_finalized_out_of_budget():
    base = g_device_budget.resident_bytes()
    sh = _shard(2048, 2)
    assert g_device_budget.resident_bytes() == base + 2048
    assert memstore_device_perf_counters().get("resident_bytes") == \
        base + 2048
    del sh
    gc.collect()
    assert g_device_budget.resident_bytes() == base


def test_demote_preserves_bytes_and_crc():
    sh = _shard(512, 8)
    sh.demote()
    assert not sh.is_resident and bytes(sh) == _payload(512, 8)
    assert crc32c(bytes(sh)) == sh.crc
    sh.demote()


def test_corrupted_changes_only_that_shard():
    """corrupted() flips a byte of one resident body: its CRC no longer
    matches, and neither its siblings' bodies nor the tensor it held
    before change."""
    sh = resident.encode_resident_shards(
        _port(4, 2), np.random.default_rng(9).integers(0, 256, (3, 4, 64),
                                                        np.uint8))
    held = sh[1].device_array()
    snap = {i: d.device_array().clone() for i, d in sh.items()}
    assert sh[1].corrupted() is sh[1]
    assert crc32c_device.crc32c_of_device_array(
        sh[1].device_array()) != sh[1].crc
    assert torch.equal(held, snap[1])
    for i, d in sh.items():
        if i != 1:
            assert torch.equal(d.device_array(), snap[i])
            assert crc32c_device.crc32c_of_device_array(
                d.device_array()) == d.crc
    host = _shard(32, 10)
    host.materialize()
    host.corrupted()
    assert crc32c(bytes(host)) != host.crc


def test_shard_validates_body():
    with pytest.raises(ValueError):
        DeviceShard(torch.zeros(8, dtype=torch.uint8), 9, 0)
    with pytest.raises(ValueError):
        DeviceShard(torch.zeros((2, 4), dtype=torch.uint8), 8, 0)
