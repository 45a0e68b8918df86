"""The port's ``parallel/`` against the JAX package's, on the CPU.

JAX side: ``ceph_tpu.parallel`` on the 8 virtual CPU devices that
``tests/conftest.py`` sets up.  Port side: ``ceph_tpu_torch.parallel`` on 8
CPU mesh members (``set_members_per_device(8)``), where K1 and K9x take
their plain versions.  Both get the same numpy inputs from a seed, and
every output is held byte-exact: sharded encode and decode, the
survivor-sharded decode (the port XOR-reduces u8 partial products where
JAX sums int32 accumulators), the stripe-to-chunk reshard, the
pipeline step's chunks and digests and the sharded CRUSH rows.  The
roofline differs by design: the port scales by distinct devices, so 8
members on one CPU read 1x where JAX's 8 virtual devices read 8x.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ceph_tpu.bench.roofline import EC_ENCODE_K8M4 as JAX_K8M4
from ceph_tpu.bench.roofline import validate_reading as jax_validate
from ceph_tpu.crush import CRUSH_BUCKET_STRAW2 as J_STRAW2
from ceph_tpu.crush import CrushWrapper as JaxCrushWrapper
from ceph_tpu.gf.matrices import gf_gen_rs_matrix
from ceph_tpu.parallel import ShardedRS as JaxShardedRS
from ceph_tpu.parallel import example_pipeline_args as jax_pipeline_args
from ceph_tpu.parallel import make_mesh as jax_make_mesh
from ceph_tpu.parallel import mesh_roofline as jax_mesh_roofline
from ceph_tpu.parallel import mesh_shape_for as jax_mesh_shape_for
from ceph_tpu.parallel import pipeline_step as jax_pipeline_step
from ceph_tpu.parallel.crush import ShardedFastRule as JaxShardedFastRule
from ceph_tpu.parallel.mesh import STRIPE_AXIS as JAX_STRIPE

from ceph_tpu_torch.bench.roofline import EC_ENCODE_K8M4, validate_reading
from ceph_tpu_torch.crush import CRUSH_BUCKET_STRAW2, CrushWrapper
from ceph_tpu_torch.ec.rs_codec import MatrixRSCodec
from ceph_tpu_torch.mesh import set_members_per_device
from ceph_tpu_torch.ops import mesh_xor
from ceph_tpu_torch.ops.crush_fast import compile_fast_rule
from ceph_tpu_torch.parallel import (ShardedRS, Sharded, drain_sharded,
                                     example_pipeline_args, make_mesh,
                                     mesh_roofline, mesh_shape_for,
                                     pipeline_step)
from ceph_tpu_torch.parallel.crush import ShardedFastRule
from ceph_tpu_torch.parallel.mesh import STRIPE_AXIS

set_members_per_device(8)


def _data(seed, s, k, c):
    return np.random.default_rng(seed).integers(0, 256, size=(s, k, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n,max_shard", [(8, 2), (1, 2), (7, 2), (4, 4),
                                         (6, 4)])
def test_mesh_shape_factoring_equal(n, max_shard):
    assert mesh_shape_for(n, max_shard) == jax_mesh_shape_for(n, max_shard)


def test_make_mesh_layout_and_refusal():
    mesh = make_mesh(8)
    assert dict(mesh.shape) == dict(jax_make_mesh(8).shape)
    assert mesh.size == 8 and mesh.platform == "cpu"
    assert len(mesh.distinct_devices) == 1
    # more members than the process has raises: no relocation elsewhere
    with pytest.raises(ValueError, match="members"):
        make_mesh(9)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_encode_equal(n):
    k, m, s, c = 8, 4, 16, 512
    mat = gf_gen_rs_matrix(k + m, k)
    data = _data(7, s, k, c)
    got = ShardedRS(mat, make_mesh(n)).encode(data)
    ref = np.asarray(JaxShardedRS(mat, jax_make_mesh(n)).encode(data))
    host = MatrixRSCodec(mat)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.stack([host.encode(d) for d in data]))


def test_sharded_encode_device_pieces_per_member():
    k, m, s, c = 8, 4, 16, 256
    sh = ShardedRS(gf_gen_rs_matrix(k + m, k), make_mesh(8))
    out = sh.encode_device(torch.from_numpy(_data(3, s, k, c)))
    assert isinstance(out, Sharded)
    assert len(out.addressable_shards) == 8
    # (4, 2) mesh: stripe blocks of 4, coding-row blocks of 2
    assert {tuple(p.data.shape) for p in out.addressable_shards} \
        == {(4, 2, c)}
    assert drain_sharded(out) == 8
    assert drain_sharded(np.arange(4)) == 1


def test_sharded_decode_equal():
    k, m, s, c = 4, 2, 8, 256
    mat = gf_gen_rs_matrix(k + m, k)
    data = _data(8, s, k, c)
    port = ShardedRS(mat, make_mesh(8))
    ref = JaxShardedRS(mat, jax_make_mesh(8))
    coding = port.encode(data)
    srcs = [1, 3, 4, 5]
    survivors = np.concatenate([data, coding], axis=1)[:, srcs, :]
    got = port.decode_data(survivors, srcs, [0, 2])
    assert np.array_equal(got, np.asarray(ref.decode_data(survivors, srcs,
                                                          [0, 2])))
    assert np.array_equal(got[:, 0], data[:, 0])
    assert np.array_equal(got[:, 1], data[:, 2])


def test_survivor_sharded_decode_equal():
    """Each member decodes its k-slice into a u8 partial and K9x (its
    plain version here) XOR-reduces them: byte-equal to JAX's psum of
    int32 accumulators, to the replicated decode and to the data."""
    k, m, s, c = 8, 4, 16, 256
    mat = gf_gen_rs_matrix(k + m, k)
    data = _data(9, s, k, c)
    port = ShardedRS(mat, make_mesh(8))
    ref = JaxShardedRS(mat, jax_make_mesh(8))
    allc = np.concatenate([data, port.encode(data)], axis=1)
    srcs = [1, 2, 3, 5, 6, 7, 8, 10]
    survivors = allc[:, srcs, :]
    got = port.decode_data_survivor_sharded(survivors, srcs, [0, 4])
    want = np.asarray(ref.decode_data_survivor_sharded(survivors, srcs,
                                                       [0, 4]))
    assert np.array_equal(got, want)
    assert np.array_equal(got, port.decode_data(survivors, srcs, [0, 4]))
    assert np.array_equal(got[:, 0], data[:, 0])
    assert np.array_equal(got[:, 1], data[:, 4])
    # a k not divisible by the shard axis is refused by both
    sv5 = np.zeros((8, 5, 64), np.uint8)
    for cls, mk in ((ShardedRS, make_mesh), (JaxShardedRS, jax_make_mesh)):
        with pytest.raises(ValueError):
            cls(gf_gen_rs_matrix(7, 5), mk(8)).decode_data_survivor_sharded(
                sv5, [0, 1, 2, 3, 4], [5])


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_xor_reduce_plain_is_the_xor(n):
    parts = torch.from_numpy(_data(n, n, 5, 33))
    got = mesh_xor.xor_reduce(parts)
    want = np.bitwise_xor.reduce(parts.numpy(), axis=0)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(mesh_xor.xor_reduce_plain(parts).numpy(), want)
    out = torch.empty((5, 33), dtype=torch.uint8)
    assert mesh_xor.xor_reduce(parts, out=out) is out
    assert np.array_equal(out.numpy(), want)
    assert mesh_xor.launches.n == 0        # no kernel ran on the CPU


def test_reshard_stripes_to_chunks_equal():
    k, m, s, c = 8, 4, 16, 256
    mat = gf_gen_rs_matrix(k + m, k)
    data = _data(11, s, k, c)
    port = ShardedRS(mat, make_mesh(8))
    ref = JaxShardedRS(mat, jax_make_mesh(8))
    allc = np.concatenate([data, port.encode(data)], axis=1)
    out = port.reshard_stripes_to_chunks(allc)
    jout = ref.reshard_stripes_to_chunks(jnp.asarray(allc))
    assert np.array_equal(out.numpy(), allc)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    # chunk-split over the stripe axis: member (a, b) holds rows slice a
    assert out.spec == (None, STRIPE_AXIS, None)
    assert jout.sharding.is_equivalent_to(
        NamedSharding(ref.mesh, P(None, JAX_STRIPE, None)), ndim=3)
    assert {tuple(p.data.shape) for p in out.addressable_shards} \
        == {(s, 3, c)}
    for bad in (port, ref):
        with pytest.raises(ValueError):
            bad.reshard_stripes_to_chunks(
                np.zeros((8, 5, 64), np.uint8) if bad is port
                else jnp.zeros((8, 5, 64), jnp.uint8))


def test_pipeline_step_equal():
    """Chunks and the uint32 digests (int64 with a mask in the port) equal
    JAX's over the (4, 2) mesh, with and without the mesh."""
    mesh = make_mesh(8)
    jmesh = jax_make_mesh(8)
    jargs = jax_pipeline_args(jmesh, s=8, k=8, m=4, c=256)
    with jmesh:
        jchunks, jdig = jax.jit(jax_pipeline_step)(*jargs)
    args = example_pipeline_args(mesh, s=8, k=8, m=4, c=256)
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    for m in (mesh, None):
        chunks, dig = pipeline_step(*args, mesh=m)
        assert np.array_equal(chunks.numpy(), np.asarray(jchunks))
        assert dig.dtype == torch.int64
        assert np.array_equal(dig.numpy().astype(np.uint32),
                              np.asarray(jdig))


def _crush_pair(n_hosts, per, weights):
    out = []
    for CW, straw2 in ((CrushWrapper, CRUSH_BUCKET_STRAW2),
                       (JaxCrushWrapper, J_STRAW2)):
        cw = CW()
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts = []
        for h in range(n_hosts):
            osds = list(range(h * per, (h + 1) * per))
            hosts.append(cw.add_bucket(straw2, 1, f"h{h}", osds,
                                       weights[h], id=-(h + 2)))
        cw.set_max_devices(n_hosts * per)
        cw.add_bucket(straw2, 10, "default", hosts,
                      [sum(w) for w in weights], id=-1)
        rno = cw.add_simple_rule("data", "default", "host", mode="firstn")
        out.append((cw, rno))
    return out


@pytest.mark.parametrize("uniform", [True, False])
def test_sharded_crush_rows_equal(uniform):
    """PGs split over 8 members map to the rows of the port's FastRule,
    of JAX's sharded rule and of the host do_rule."""
    rng = np.random.default_rng(3)
    n_hosts, per = 8, 4
    weights = [[0x10000] * per if uniform else
               [int(w) for w in rng.integers(0x9000, 0x22000, per)]
               for _ in range(n_hosts)]
    (cw, rno), (jcw, jrno) = _crush_pair(n_hosts, per, weights)
    n_osds = n_hosts * per
    xs = np.arange(300, dtype=np.uint32)       # 300 % 8 != 0: padded
    w = np.full(n_osds, 0x10000, dtype=np.uint32)
    w[7] = 0
    sf = ShardedFastRule(cw.crush, rno, 3, make_mesh(8))
    res, cnt = sf.map_batch(xs, w)
    fr = compile_fast_rule(cw.crush, rno, 3, device="cpu")
    fres, fcnt = fr.map_batch(xs, w)
    jres, jcnt = JaxShardedFastRule(jcw.crush, jrno, 3,
                                    jax_make_mesh(8)).map_batch(xs, w)
    assert np.array_equal(cnt, fcnt) and np.array_equal(cnt, jcnt)
    for x in range(len(xs)):
        row = [int(v) for v in res[x, :cnt[x]]]
        assert row == [int(v) for v in fres[x, :fcnt[x]]]
        assert row == [int(v) for v in jres[x, :jcnt[x]]]
    for x in range(0, len(xs), 17):
        assert [int(v) for v in res[x, :cnt[x]]] == \
            cw.do_rule(rno, int(x), 3, [int(v) for v in w])
    packed = sf.resolve_device(w)
    assert len(packed.addressable_shards) == 8
    assert 0.0 <= sf.residual_fraction <= 1.0


def test_mesh_roofline_scales_by_distinct_devices():
    """By design: 8 members on one CPU share its peaks (1x), where JAX's
    8 virtual devices scale the peaks 8x."""
    mesh = make_mesh(8)
    single = validate_reading(10.0, EC_ENCODE_K8M4, "cpu", "", 1)
    port = mesh_roofline(10.0, EC_ENCODE_K8M4, mesh, platform="cpu")
    assert port["peak_tops"] == single["peak_tops"]
    assert port["peak_hbm_gibs"] == single["peak_hbm_gibs"]
    ref = jax_mesh_roofline(10.0, JAX_K8M4, jax_make_mesh(8),
                            platform="cpu")
    jsingle = jax_validate(10.0, JAX_K8M4, "cpu", "", 1)
    assert ref["peak_tops"] == 8 * jsingle["peak_tops"]
    assert single["peak_tops"] == jsingle["peak_tops"]
    assert ShardedRS(gf_gen_rs_matrix(12, 8), mesh).roofline(
        25.0, EC_ENCODE_K8M4)["suspect"] is True
