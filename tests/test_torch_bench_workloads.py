"""The port's fenced EC workloads against the JAX package's, on the CPU.

Port side: ``ceph_tpu_torch.bench.workloads`` with ``device="cpu"``
(K1's plain version on CPU tensors); reference side:
``ceph_tpu.bench.workloads`` on the CPU.  The salted step's bytes must
be equal for the same salts; the fenced encode/decode metrics must carry
the JAX package's names and keys (their values are timings, which no two
runs share); ``parity_check`` must hold on both.
"""
import numpy as np
import pytest
import torch

import ceph_tpu.bench.workloads as jw
import jax.numpy as jnp
from ceph_tpu.gf.matrices import gf_gen_rs_matrix
from ceph_tpu.gf.tables import expand_to_bitmatrix

import ceph_tpu_torch.bench.workloads as pw
from ceph_tpu_torch.ops import gf_pallas
from ceph_tpu_torch.trace import g_devprof

MATRIX = gf_gen_rs_matrix(12, 8)


def _batch(seed, s=2, c=4096):
    return np.random.default_rng(seed).integers(0, 256, (s, 8, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("salt", [0, 1, 0x7FFFFFFF, 0x80000000,
                                  0xDEADBEEF, 0xFFFFFFFF])
def test_salted_step_bytes_equal(salt):
    d = _batch(41 + salt % 7, s=3, c=256)
    bits = expand_to_bitmatrix(MATRIX[8:])
    want = np.asarray(jw.salted_matmul_step()(
        jnp.asarray(d), jnp.asarray(bits.astype(np.int8)),
        jnp.uint32(salt)))
    got = pw.salted_matmul_step()(torch.from_numpy(d),
                                  gf_pallas.BitMatrix(bits, "cpu"), salt)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def _metric_shape(m):
    return (m["name"], m["unit"], m["fenced"], sorted(m),
            sorted(m["stats"]), sorted(m["roofline"]), sorted(m["devflow"]),
            sorted(m["stage_breakdown"]))


def test_encode_and_decode_metrics_carry_the_jax_names_and_keys():
    batch = _batch(42)
    kw = dict(target_seconds=0.2, repeats=2, warmup=1)
    j_enc = jw.measure_encode(MATRIX, batch, **kw)
    j_dec = jw.measure_decode(MATRIX, batch, **kw)
    gf_pallas.launches.reset()
    flow0 = g_devprof.snapshot()
    p_enc = pw.measure_encode(MATRIX, batch, device="cpu", **kw)
    p_dec = pw.measure_decode(MATRIX, batch, device="cpu", **kw)
    assert _metric_shape(p_enc) == _metric_shape(j_enc)
    assert _metric_shape(p_dec) == _metric_shape(j_dec)
    # the port's step is held to the bytes it moves, not to JAX's model
    assert p_enc["roofline"]["workload"] == "ec_encode_k8m4_salted"
    assert p_dec["roofline"]["workload"] == "ec_decode_k8m4_e2_salted"
    for m in (p_enc, p_dec):
        assert m["value"] > 0 and not m["suspect"]
        assert m["platform"] == "cpu" and m["n_devices"] == 1
        assert m["roofline"]["verdict"] == "ok"
        assert m["roofline"]["implied_tops"] == 0.0     # no int8 MACs
        assert m["bytes_per_step"] == batch.nbytes
        # one one-byte drain per fenced region, nothing else crosses
        fences = m["stats"]["n"] + len(m["stats"]["warmup_samples"])
        assert m["devflow"]["d2h_bytes"] == fences
        assert m["devflow"]["h2d_bytes"] == 0
        assert set(m["stage_breakdown"]["stages"]) == {"device_call", "d2h"}
    # the decode matrix upload is the only other transfer of the two runs
    flow = pw.devflow_delta(flow0, g_devprof.snapshot(), 1)
    assert flow["h2d_bytes"] == 64 * 16 + 4 * 8 * 32
    # the CPU route takes the plain version: the kernel counter stays
    assert gf_pallas.launches.n == 0


def test_parity_check_holds_on_both():
    assert jw.parity_check(MATRIX)
    assert pw.parity_check(MATRIX, device="cpu")


def test_mesh_branch_runs_and_missing_card_raises():
    """The fenced step over 8 CPU mesh members, drained per member, reads
    like the JAX mesh branch on its 8 virtual devices, with the roofline
    scaled by the one distinct device; without a card the default raises."""
    from ceph_tpu.mesh.topology import batch_mesh as jax_batch_mesh
    from ceph_tpu_torch.mesh import batch_mesh, set_members_per_device
    set_members_per_device(8)
    bits = gf_pallas.BitMatrix(expand_to_bitmatrix(MATRIX[8:]), "cpu")
    batch = _batch(43, s=16, c=16384)
    kw = dict(metric_name="x", kernel_name="x", target_seconds=0.1,
              repeats=1, warmup=0, rtt_s=1e-6, n_steps=2)
    m = pw._measure_fenced_gf(bits, batch,
                              workload=pw.EC_ENCODE_K8M4_SALTED,
                              mesh=batch_mesh(8, platform="cpu"), **kw)
    j = jw._measure_fenced_gf(
        jnp.asarray(expand_to_bitmatrix(MATRIX[8:]).astype(np.int8)),
        batch, workload=jw.EC_ENCODE_K8M4, mesh=jax_batch_mesh(8), **kw)
    assert m.keys() - {"mesh_members"} == j.keys()
    assert m["mesh_members"] == 8 and m["n_devices"] == 1
    assert j["n_devices"] == 8
    assert m["n_steps"] == j["n_steps"] == 2
    assert m["bytes_per_step"] == j["bytes_per_step"]
    with pytest.raises(ValueError):
        pw._measure_fenced_gf(bits, _batch(44, s=12),
                              workload=pw.EC_ENCODE_K8M4_SALTED,
                              mesh=batch_mesh(8, platform="cpu"), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pw.measure_encode(MATRIX, _batch(44))          # default: card
    assert pw._device_info("cpu") == ("cpu", "", 1)
