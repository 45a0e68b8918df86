"""The case twins of the RADOS, monitor, telemetry and pipeline layers:
every case of a set of JAX test modules, each parametrised variant on its
own, run on both packages by ``torch_rbd_twin.run_both``.

``twin_table(modules)`` returns the modules by name, their ports
(``port_module`` with the module's ``BY_DESIGN`` edits) and the cases as
``(module, case, variant id, params)`` rows; ``case_ids`` names them for
``pytest.mark.parametrize``.

``BY_DESIGN`` is the one table of the places where a case, as the JAX
package wrote it, cannot run on the port for a reason ``ROADMAP.md``
writes under "By design, pinned".  Each entry is ``(old, new, reason)``:
the text of the port's copy of the case that is replaced, and the
heading of the ``ROADMAP.md`` entry it rests on.  The JAX side always
runs the case unchanged, and the two runs are still held equal: same
output, same stores.  Where a case checks a surface the port does not
have (a breaker, a CPU fallback), the edit drops that check and keeps
the rest of the case, which is the portable part.  ``NOT_RUN`` lists the
cases that check nothing but such a surface, with the same reasons, and
``WALL_CLOCK`` the cases whose stores follow the wall clock.
Cases the JAX suite marks ``slow`` are left out of the tables, as its
tier-1 run leaves them out.
"""
from torch_rbd_twin import (JAX, PORT, assert_same_runs, case_names,
                            case_variants, port_module, run_both)

NO_BREAKERS = "No codec breakers in the cluster (PR 16)."
CUDA_CODEC = "The autotune and the storylines run `ErasureCodeCuda` (PR 20)."
SILENT_SITE = "The `device_error` leg's site is silent in the port (PR 20)."
CPU_BY_NAME = "The case twins ask for the CPU by name (PR 24)."
NO_GUARD = "The fault package has no guard and no breaker (PR 13)."
MESH_MEMBERS = "The mesh is one process with explicit members."
ANALYZER = "The analyzer names the port's device calls."
TORCH_VALUES = "A case's jax values are torch tensors on the port."
FENCE_TENSORS = "The bench fence drains tensors."
TORCH_SYNCS = "The zero-sync gate counts torch's syncs."
NVCC_COMPILES = "A compile is an nvcc run."
EXACT_DRAWS = "The port's CRUSH draws are always exact."

_CUDA_IMPORT = (
    "from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu",
    "from ceph_tpu.ec.cuda_plugin import ErasureCodeCuda as ErasureCodeTpu",
    CUDA_CODEC)


def _host_init(k, m):
    old = f'impl.init({{"k": "{k}", "m": "{m}", "technique": "reed_sol_van"}})'
    return (old, old[:-2] + ', "backend": "host"})', CPU_BY_NAME)


BY_DESIGN = {
    "test_incident": [
        ("from ceph_tpu.fault import g_breakers, g_faults",
         "from ceph_tpu.fault import g_faults", NO_BREAKERS),
        ("    g_breakers.reset()\n", "", NO_BREAKERS),
        ('"breakers_open", "chip_scoreboard"', '"chip_scoreboard"',
         NO_BREAKERS),
        _CUDA_IMPORT, _host_init(4, 2),
    ],
    "test_control_loop": [_CUDA_IMPORT, _host_init(4, 2)],
    "test_pipeline": [
        ("    from ceph_tpu.fault import (fault_perf_counters, g_breakers,\n"
         "                                g_faults)\n",
         "    from ceph_tpu.fault import fault_perf_counters, g_faults\n",
         NO_BREAKERS),
        ('        assert pc.get(l_fault_cpu_fallbacks) > fb0, \\\n'
         '            "continuation-path device error did not reach the '
         'CPU twin"\n'
         '        assert g_breakers.degraded(), "breaker never tripped"\n',
         "", SILENT_SITE),
        ("        g_breakers.reset()\n", "", NO_BREAKERS),
        _CUDA_IMPORT, _host_init(2, 1),
    ],
    "test_dout_trace": [
        ("DeviceRSBackend(gf_gen_rs_matrix(6, 4))",
         "DeviceRSBackend(gf_gen_rs_matrix(6, 4), device=\"cpu\")",
         CPU_BY_NAME),
    ],
    "test_recovery_storm": [
        ("n_clients=3, ops_per_client=6)",
         "n_clients=3, ops_per_client=6, device=\"cpu\")", CPU_BY_NAME),
    ],
    "test_lockdep": [
        ("    from ceph_tpu.fault import g_breakers, g_faults\n",
         "    from ceph_tpu.fault import g_faults\n", NO_BREAKERS),
        ('(g_faults, "_lock"), (g_breakers, "_lock")):',
         '(g_faults, "_lock")):', NO_BREAKERS),
    ],
    "test_ec_plugins": [
        ('("isa", "jerasure", "tpu", "example_xor")',
         '("isa", "jerasure", "cuda", "example_xor")', CPU_BY_NAME),
    ],
    "test_crush_compat": [
        ("OSDMapMapping()", "OSDMapMapping(device=\"cpu\")", CPU_BY_NAME),
        ('mapping.last_backend[pid] == "device"',
         'mapping.last_backend[pid] == "cpu"', CPU_BY_NAME),
    ],
    "test_lrc": [
        ('backend_name == "tpu" for l in dev.layers',
         'backend_name == "host" for l in dev.layers', CPU_BY_NAME),
    ],
    "test_bench_harness": [
        ("    import jax\n"
         "    import jax.numpy as jnp\n\n"
         "    f = jax.jit(lambda x, s: x * s)\n"
         "    x = jnp.arange(1024, dtype=jnp.int32)\n"
         "    timing = fence.fenced_time(lambda i: f(x, jnp.int32(i + 1)), 4)\n",
         "    import torch\n\n"
         "    def f(x, s):\n"
         "        return x * s\n"
         "    x = torch.arange(1024, dtype=torch.int32)\n"
         "    timing = fence.fenced_time(lambda i: f(x, i + 1), 4,\n"
         "                               rtt_s=fence.measure_rtt(device=\"cpu\"))\n",
         TORCH_VALUES),
        ("    rtt = fence.measure_rtt(lambda: np.ones(8, dtype=np.int32), "
         "repeats=3)\n",
         "    import torch\n"
         "    rtt = fence.measure_rtt(lambda: torch.ones(8, dtype=torch.int32), "
         "repeats=3)\n", FENCE_TENSORS),
        ('    assert mmesh["n_devices"] == 8\n',
         '    assert mmesh["n_devices"] == 1\n', MESH_MEMBERS),
        ("workloads.measure_encode(matrix, batch, target_seconds=0.2,\n"
         "                                     repeats=2, warmup=1)",
         "workloads.measure_encode(matrix, batch, target_seconds=0.2,\n"
         "                                     repeats=2, warmup=1, "
         "device=\"cpu\")", CPU_BY_NAME),
        ("workloads.measure_decode(matrix, batch, target_seconds=0.2,\n"
         "                                      repeats=2, warmup=1)",
         "workloads.measure_decode(matrix, batch, target_seconds=0.2,\n"
         "                                      repeats=2, warmup=1, "
         "device=\"cpu\")", CPU_BY_NAME),
        ("workloads.parity_check(matrix) is True",
         "workloads.parity_check(matrix, device=\"cpu\") is True",
         CPU_BY_NAME),
        ("        n_requests=4, object_bytes=16384, target_seconds=0.1,\n"
         "        repeats=2, warmup=1)",
         "        n_requests=4, object_bytes=16384, target_seconds=0.1,\n"
         "        repeats=2, warmup=1, device=\"cpu\")", CPU_BY_NAME),
    ],
    "test_observability": [
        ("    import jax\n", "    import torch\n", TORCH_SYNCS),
        ("    real = jax.block_until_ready\n\n"
         "    def counting(x):\n"
         "        calls[\"n\"] += 1\n"
         "        return real(x)\n\n"
         "    monkeypatch.setattr(jax, \"block_until_ready\", counting)\n",
         "    real = torch.cuda.synchronize\n\n"
         "    def counting(*a, **kw):\n"
         "        calls[\"n\"] += 1\n"
         "        return real(*a, **kw)\n\n"
         "    monkeypatch.setattr(torch.cuda, \"synchronize\", counting)\n"
         "    for cls in (torch.cuda.Event, torch.cuda.Stream):\n"
         "        monkeypatch.setattr(cls, \"synchronize\", counting)\n"
         "    from ceph_tpu.bench import fence\n"
         "    monkeypatch.setattr(fence, \"drain\", counting)\n",
         TORCH_SYNCS),
        ("    from ceph_tpu.fault import fault_perf_counters, g_breakers, "
         "g_faults\n",
         "    from ceph_tpu.fault import fault_perf_counters, g_faults\n",
         NO_BREAKERS),
        ("    assert g_breakers.degraded() == []\n", "", NO_BREAKERS),
        ("    r = run_seed(24)\n", "    r = run_seed(24, device=\"cpu\")\n",
         CPU_BY_NAME),
    ],
    "test_parallel": [
        ("import jax.numpy as jnp\n", "import jax.numpy as jnp\nimport torch\n",
         TORCH_VALUES),
        ("    out = sharded.reshard_stripes_to_chunks(jnp.asarray(allc))\n"
         "    assert np.array_equal(np.asarray(out), allc)\n",
         "    out = sharded.reshard_stripes_to_chunks(torch.from_numpy(allc))\n"
         "    assert np.array_equal(out.numpy(), allc)\n", TORCH_VALUES),
        ("    want = NamedSharding(sharded.mesh, P(None, STRIPE_AXIS, None))\n"
         "    assert out.sharding.is_equivalent_to(want, ndim=3)\n",
         "    assert out.spec == (None, STRIPE_AXIS, None)\n", TORCH_VALUES),
        ("            jnp.zeros((8, 5, 64), jnp.uint8))",
         "            torch.zeros((8, 5, 64), dtype=torch.uint8))",
         TORCH_VALUES),
        ("    with mesh:\n"
         "        chunks, digests = jax.jit(pipeline_step)(*args)\n"
         "    chunks = np.asarray(chunks)\n"
         "    data = np.asarray(args[0])\n",
         "    chunks, digests = pipeline_step(*args, mesh=mesh)\n"
         "    chunks = chunks.numpy()\n"
         "    data = args[0].numpy()\n", TORCH_VALUES),
        ("    assert len(packed.sharding.device_set) == 8\n",
         "    assert len(packed.addressable_shards) == 8\n", MESH_MEMBERS),
        ("    assert sf.fr._exact64        # non-uniform weights: "
         "exact64 is on\n", "", EXACT_DRAWS),
        ("    out = sharded.encode_device(jnp.asarray(data))\n",
         "    out = sharded.encode_device(torch.from_numpy(data))\n",
         TORCH_VALUES),
        ("    assert np.asarray(out).tobytes() == \\\n",
         "    assert out.numpy().tobytes() == \\\n", TORCH_VALUES),
        ("    mesh = make_mesh(8)\n"
         "    single = validate_reading(",
         "    from ceph_tpu.mesh.topology import Member\n"
         "    mesh = make_mesh(devices=[Member(i, torch.device(\"cpu\", i), 0)\n"
         "                              for i in range(8)])\n"
         "    single = validate_reading(", MESH_MEMBERS),
    ],
    "test_static_analysis": [
        (r"import jax\n", r"import torch\n", ANALYZER),
        ("jax.block_until_ready(x)", "torch.cuda.synchronize(x)", ANALYZER),
        ("x.block_until_ready()", "x.synchronize()", ANALYZER),
        ("jax.device_get(x)", "x.cpu()", ANALYZER),
        ("    return np.asarray(dev)", "    return dev.numpy()", ANALYZER),
        ("jax.jit", "torch.compile", ANALYZER),
        (r'"from numpy import asarray\n"', r'"from torch.cuda import synchronize\n"',
         ANALYZER),
        (r'"    return asarray(d)\n"', r'"    return synchronize(d)\n"',
         ANALYZER),
    ],
    "test_chaos": [
        ("from ceph_tpu.fault import fault_perf_counters, g_breakers, "
         "g_faults\n",
         "from ceph_tpu.fault import fault_perf_counters, g_faults\n",
         NO_BREAKERS),
        ("    g_breakers.reset()\n    for name in", "    for name in",
         NO_BREAKERS),
    ],
    "test_fault": [
        ("from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu\n", "",
         NO_GUARD),
        ("from ceph_tpu.fault import (DeviceUnavailable, InjectedDeviceError,\n"
         "                            fault_perf_counters, g_breakers, g_faults,\n"
         "                            run_device_call)\n",
         "from ceph_tpu.fault import (InjectedDeviceError, fault_perf_counters,\n"
         "                            g_faults)\n", NO_GUARD),
        ("    g_breakers.reset()\n", "", NO_BREAKERS),
    ],
}

# The cases that do not run on the port at all: each checks only a
# surface the port does not have by design.  (module, case) -> reason.
NOT_RUN = {
    ("test_fault", case): NO_GUARD for case in (
        "test_guard_retries_then_succeeds",
        "test_guard_exhaustion_raises_device_unavailable",
        "test_guard_watchdog_deadline",
        "test_guard_stops_retrying_once_breaker_trips",
        "test_breaker_trip_halfopen_restore_cycle",
        "test_failed_halfopen_probe_costs_one_attempt",
        "test_breaker_success_resets_consecutive_run",
        "test_circuit_broken_codec_byte_identical",
        "test_jerasure_family_guard_parity",
        "test_degraded_health_warning_and_prometheus",
        "test_retry_and_trip_span_events")}
NOT_RUN.update({
    ("test_regenerating", "test_breaker_open_falls_back_byte_identical"):
        NO_BREAKERS,
    ("test_bench_harness", "test_fenced_timer_waits_for_materialization"):
        FENCE_TENSORS,
    ("test_bench_harness", "test_drain_touches_host_bytes"): FENCE_TENSORS,
    ("test_devprof", "test_compile_detection_attributes_to_stage"):
        NVCC_COMPILES,
})


# Cases whose stores follow the wall clock: open-loop traffic under a
# wall-clock rate limit serves a different interleaving of reads and
# writes in each run, on either package.  They run on both packages, each
# run must pass the case's own assertions and print the same output, and
# the two runs must build as many clusters; their stores are not compared.
WALL_CLOCK = {
    ("test_qos_wall", "test_wall_rate_limit_holds_under_open_loop_smoke"),
}


def slow(mod, case) -> bool:
    """The case is marked ``slow`` (the JAX suite's tier-1 leaves it
    out, and so do the twins)."""
    return any(m.name == "slow"
               for m in getattr(getattr(mod, case), "pytestmark", ()))


def twin_table(modules):
    by_name = {m.__name__: m for m in modules}
    ports = {n: port_module(m, edits=[e[:2] for e in BY_DESIGN.get(n, ())])
             for n, m in by_name.items()}
    rows = [(n, case, vid, params) for n, m in by_name.items()
            for case in case_names(m)
            if not slow(m, case) and (n, case) not in NOT_RUN
            for vid, params in case_variants(m, case)]
    return by_name, ports, rows


def case_ids(rows):
    return [f"{m}::{c}" + (f"[{v}]" if v else "") for m, c, v, _ in rows]


def assert_case_equal(by_name, ports, mod, name, params, tmp_path, capsys):
    """The case on both packages, the port's run on one torch thread
    (``run_one``): equal output and equal stores (the output alone for a
    ``WALL_CLOCK`` case)."""
    j, p = run_both(by_name[mod], name, tmp_path, capsys, port=ports[mod],
                    params=params, torch_threads=1)
    if (mod, name) in WALL_CLOCK:
        assert p.out.replace(PORT, JAX) == j.out
        assert p.err.replace(PORT, JAX) == j.err
        assert len(p.clusters) == len(j.clusters)
        return
    assert_same_runs(j, p)
