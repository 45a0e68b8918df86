"""The port's observability core against the JAX package's, on the CPU.

Port side: ``ceph_tpu_torch.common`` (lockdep, perf counters, dout,
config, kernel_trace, admin socket, op tracker) and
``ceph_tpu_torch.trace`` (histogram, span, flight, oplat, journal).  Reference side: the same modules of
``ceph_tpu``.  Each test feeds both the same seeded numpy values or the
same event sequence, through fresh instances where the modules keep
process-wide singletons.  Dumps, counts and percentiles must be equal;
timestamps and span ids, which no two runs share, are masked.
"""
import threading

import numpy as np
import pytest

import ceph_tpu.common.config as jconfig
import ceph_tpu.common.dout as jdout
import ceph_tpu.common.kernel_trace as jkt
import ceph_tpu.common.lockdep as jlockdep
import ceph_tpu.common.perf_counters as jpc
import ceph_tpu.trace.flight as jflight
import ceph_tpu.trace.histogram as jhist
import ceph_tpu.trace.journal as jjournal
import ceph_tpu.trace.oplat as joplat
import ceph_tpu.trace.span as jspan

import ceph_tpu_torch.common as pcommon
import ceph_tpu_torch.common.config as pconfig
import ceph_tpu_torch.common.dout as pdout
import ceph_tpu_torch.common.kernel_trace as pkt
import ceph_tpu_torch.common.lockdep as plockdep
import ceph_tpu_torch.common.perf_counters as ppc
import ceph_tpu_torch.trace as ptrace
import ceph_tpu_torch.trace.flight as pflight
import ceph_tpu_torch.trace.histogram as phist
import ceph_tpu_torch.trace.journal as pjournal
import ceph_tpu_torch.trace.oplat as poplat
import ceph_tpu_torch.trace.span as pspan

def test_exports_match_the_jax_packages():
    import ceph_tpu.common as jcommon
    import ceph_tpu.trace as jtrace
    assert sorted(pcommon.__all__) == sorted(jcommon.__all__)
    assert sorted(ptrace.__all__) == sorted(jtrace.__all__)
    assert ptrace.EVENT_TYPES == jjournal.EVENT_TYPES
    assert ptrace.STAGES == joplat.STAGES


# ---- lockdep ---------------------------------------------------------------

def _inversion(mod):
    """A then B establishes A -> B; B then A must raise, with the same
    message in both packages (the first order's stack is cut off)."""
    mod.lockdep_reset()
    mod.lockdep_enable(True)
    try:
        a, b = mod.DebugLock("A"), mod.DebugLock("B")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(mod.LockOrderError) as ei:
                a.acquire()
        # a recursive acquire of the same lock is refused too
        with a:
            with pytest.raises(mod.LockOrderError) as rec:
                mod.DebugLock("A").acquire()
        # a reentrant lock's inner acquires record nothing
        r, c = mod.DebugRLock("R"), mod.DebugLock("C")
        with r:
            with r:
                with c:
                    pass
        with c:
            with pytest.raises(mod.LockOrderError) as rinv:
                r.acquire()
        return [str(e.value).split(" was established")[0]
                for e in (ei, rec, rinv)]
    finally:
        mod.lockdep_enable(False)
        mod.lockdep_reset()


def test_lockdep_raises_on_the_same_inversion():
    assert _inversion(plockdep) == _inversion(jlockdep)
    assert "lock order inversion" in _inversion(plockdep)[0]


def test_lockdep_transitive_cycle_and_condition():
    def run(mod):
        mod.lockdep_reset()
        mod.lockdep_enable(True)
        try:
            x, y, z = (mod.DebugLock(n) for n in "XYZ")
            with x, y:
                pass
            with y, z:
                pass
            with z:
                with pytest.raises(mod.LockOrderError) as ei:
                    x.acquire()
            # a Condition over a DebugLock waits and wakes without a
            # false recursive acquire
            lk = mod.DebugLock("cond")
            cv = threading.Condition(lk)
            with cv:
                cv.wait(timeout=0.001)
            return str(ei.value).split(" was established")[0]
        finally:
            mod.lockdep_enable(False)
            mod.lockdep_reset()
    assert run(plockdep) == run(jlockdep)


# ---- perf counters ---------------------------------------------------------

def _counter_run(mod):
    b = mod.PerfCountersBuilder("osd", 1000, 1010)
    b.add_u64_counter(1001, "op_w", "writes")
    b.add_u64(1002, "inflight", "gauge")
    b.add_time_avg(1003, "op_w_lat", "write latency")
    pc = b.create_perf_counters()
    rng = np.random.default_rng(3)
    for v in rng.integers(1, 9, 20):
        pc.inc(1001, int(v))
    pc.set(1002, 7)
    pc.dec(1002, 2)
    for s in rng.random(5):
        pc.tinc(1003, float(s))
    pc.hinc(1003, 0.25)
    with pytest.raises(AssertionError):
        b.add_u64(1010, "past_the_range")
    coll = mod.PerfCountersCollection()
    coll.add(pc)
    other = mod.PerfCountersBuilder("bench", 2000, 2005)
    other.add_u64_counter(2001, "fences")
    coll.add(other.create_perf_counters())
    return (pc.dump(), pc.get(1001), coll.dump(), coll.dump(logger="osd"),
            coll.dump(counter="inflight"))


def test_perf_counters_dump_equal():
    assert _counter_run(ppc) == _counter_run(jpc)


def test_port_counter_get_by_name():
    b = ppc.PerfCountersBuilder("x", 0, 5)
    b.add_u64(1, "g")
    pc = b.create_perf_counters()
    pc.set(1, 42)
    assert pc.get("g") == pc.get(1) == 42
    with pytest.raises(KeyError):
        pc.get("nope")


# ---- histograms and percentiles --------------------------------------------

def _hist_run(mod):
    rng = np.random.default_rng(11)
    lat = mod.PerfHistogram(mod.latency_axes())
    lat2d = mod.PerfHistogram(mod.latency_in_bytes_axes())
    occ = mod.PerfHistogram(mod.occupancy_axes())
    for v in rng.lognormal(6, 2, 500):
        lat.inc(float(v))
    for v, s in zip(rng.lognormal(5, 2, 300), rng.integers(0, 1 << 22, 300)):
        lat2d.inc(float(v), int(s))
    for v in rng.integers(0, 80, 200):
        occ.inc(int(v))
    other = mod.PerfHistogram(mod.latency_axes())
    for v in rng.lognormal(4, 1, 100):
        other.inc(float(v))
    with pytest.raises(ValueError):
        mod.merge_axis0([lat, occ])
    coll = mod.PerfHistogramCollection()
    coll.get("osd.0", "op_lat", mod.latency_axes).inc(350.0)
    coll.get("osd.1", "op_lat", mod.latency_axes).inc(12.0)
    with pytest.raises(KeyError):
        coll.get("osd.2", "missing")
    counts = [int(c) for c in rng.integers(0, 9, 12)]
    edges = [float(e) for e in np.cumsum(rng.integers(1, 50, 12))] \
        + [float("inf")]
    return {
        "dumps": [h.dump() for h in (lat, lat2d, occ)],
        "cum": lat.cumulative_axis0(),
        "marginal": lat2d.marginal_axis0(),
        "edges": [ax.upper_edges() for ax in
                  mod.latency_in_bytes_axes() + mod.pipeline_axes()],
        "p": mod.hist_percentiles(lat),
        "p_occ": mod.hist_percentiles(occ, qs=(0.25, 0.5, 0.9)),
        "merged": mod.merged_percentiles([lat, other], suffix="_usec"),
        "raw": mod.percentiles_from_counts(counts, edges[:12] + edges[-1:],
                                           qs=(0.1, 0.5, 0.999)),
        "empty": mod.percentiles_from_counts([0, 0], [1.0, float("inf")]),
        "coll": coll.dump(), "coll_osd1": coll.dump(logger="osd.1"),
    }


def test_histogram_dumps_and_percentiles_equal():
    assert _hist_run(phist) == _hist_run(jhist)


# ---- spans and the flight recorder -----------------------------------------

def _mask_tree(nodes, ids):
    out = []
    for d in nodes:
        ids.setdefault(d["span_id"], len(ids))
        tags = {k: v for k, v in d["tags"].items() if k != "events"}
        tags["events"] = [{k: v for k, v in e.items() if k != "t"}
                          for e in d["tags"].get("events", [])]
        out.append({"id": ids[d["span_id"]],
                    "parent": ids.get(d["parent_span_id"], "outside"),
                    "name": d["name"], "daemon": d["daemon"],
                    "closed": d["end"] is not None, "tags": tags,
                    "children": _mask_tree(d["children"], ids)})
    return out


def _span_run(spanmod, flightmod):
    tr = spanmod.Tracer()
    assert tr.begin("off") is None           # disabled: no span at all
    tr.enable()
    root = tr.begin("client_op", daemon="client.0", trace_id=77)
    with tr.activate(root):
        with tr.span("osd_op", daemon="osd.1") as sp:
            sp.tags["pg"] = "1.2"
            tr.event("retry", attempt=1)
            with tr.span("kernel:gf_encode", daemon="osd.1"):
                pass
        orphan = tr.begin("sub_write", daemon="osd.2", parent_id=10 ** 9)
        tr.finish(orphan)
    tr.begin("other_trace", trace_id=78)
    spans = tr.collector.spans_for_trace(77)
    tree = _mask_tree(spanmod.build_tree(spans), {})
    fr = flightmod.FlightRecorder(size=2)
    for i in range(3):
        fr.record(77, f"op {i}", 0.5 + i, spans)
    tr.finish(root)                           # closes in place, pinned
    flight = [(e["trace_id"], e["description"], e["duration"],
               _mask_tree(e["span_tree"], {}))
              for e in fr.dump()["slow_ops"]]
    return (tree, flight, sorted(tr.collector.dump()),
            [d["name"] for d in tr.collector.dump("osd.1")["osd.1"]])


def test_build_tree_and_flight_equal_with_ids_and_times_masked():
    assert _span_run(pspan, pflight) == _span_run(jspan, jflight)


# ---- the stage-latency ledger ----------------------------------------------

def _oplat_run(mod, histmod, monkeypatch):
    """Injected times through fresh registries: ledger marks, direct
    records, the dump, and a bench-style breakdown between snapshots."""
    monkeypatch.setattr(mod, "g_perf_histograms",
                        histmod.PerfHistogramCollection())
    monkeypatch.setattr(mod, "_oplat_pc", None)
    acc = mod.OpLatAccumulator()
    monkeypatch.setattr(mod, "g_oplat", acc)
    rng = np.random.default_rng(5)
    before = acc.snapshot()
    ledgers = []
    for op in range(40):
        led = mod.OpLedger(daemon=f"osd.{op % 3}", t0=0.0)
        t = 0.0
        for stage in mod.STAGES:
            if rng.random() < 0.2:
                continue
            t += float(rng.lognormal(-9, 1.5))
            led.mark(stage, t=t)
        acc.note_op()
        ledgers.append(led.dump())
    for stage in ("device_call", "d2h"):
        acc.record("bench", stage, float(rng.lognormal(4, 1)))
    with acc.activate(mod.OpLedger(daemon="osd.9", t0=1.0)) as cur:
        assert acc.current() is cur
        acc.checkpoint("admission", t=1.5)
        acc.checkpoint("reply", t=1.0)    # earlier than the last stamp
    acc.checkpoint("reply")               # no op active: no-op
    out = {"ledgers": ledgers, "dump": acc.dump(),
           "dump_osd1": acc.dump("osd.1"),
           "breakdown": acc.breakdown_since(before, 0.75, 40),
           "names": (mod.stage_hist_name("d2h"),
                     mod.stage_of_hist_name("oplat_d2h_latency_histogram"),
                     mod.stage_of_hist_name("other"))}
    acc.reset()
    out["after_reset"] = acc.dump()
    return out


def test_oplat_breakdowns_equal_for_injected_times(monkeypatch):
    port = _oplat_run(poplat, phist, monkeypatch)
    jax = _oplat_run(joplat, jhist, monkeypatch)
    assert port == jax
    assert port["breakdown"]["stages"]


# ---- the event journal -----------------------------------------------------

def _journal_run(mod):
    j = mod.EventJournal()
    j.set_clock(12.5)
    for i in range(6):
        j.emit(f"osd.{i % 2}", "osd_down", osd=i)
    j.set_clock(13.25)
    j.emit("mgr", "health_raise", check="TPU_SLO_OPLAT")
    with pytest.raises(ValueError):
        j.emit("mgr", "no_such_type")
    out = {"dump": j.dump(), "osd0": j.dump("osd.0"),
           "merged": j.merged(), "tail": j.merged(tail=2),
           "since": j.merged_since(3), "last": j.last_gseq(),
           "clock": j.clock()}
    out["reset"] = j.reset()
    out["after"] = j.dump()
    return out


def test_journal_dumps_equal_under_set_clock():
    assert _journal_run(pjournal) == _journal_run(jjournal)


def test_journal_ring_bound_is_live(monkeypatch):
    def run(mod, conf):
        monkeypatch.setattr(mod, "g_conf", conf)
        conf.set_val("mgr_journal_ring_size", 3)
        j = mod.EventJournal()
        for i in range(5):
            j.emit("osd.0", "osd_up", osd=i)
        return j.dump()
    assert run(pjournal, pconfig.ConfigProxy()) == \
        run(jjournal, jconfig.ConfigProxy())


# ---- config ----------------------------------------------------------------

def _opt(o):
    return (o.name, o.type, o.level, o.default, o.description,
            o.long_description)


def test_build_options_equal_option_by_option():
    port, jax = pconfig.build_options(), jconfig.build_options()
    assert [_opt(o) for o in port] == [_opt(o) for o in jax]
    assert len(port) >= 81


def _config_run(mod):
    c = mod.ConfigProxy()
    seen = []
    c.add_observer("osd_pool_default_size",
                   lambda n, v: seen.append((n, v)))
    c.set_val("osd_pool_default_size", "5")
    c.set_val("tracing_kernels", "yes")
    out = {"get": [c.get_val(n) for n in (
        "osd_pool_default_size", "tracing_kernels",
        "os_memstore_device_bytes_max", "debug_osd")]}
    out["inject"] = c.handle_config_command(
        "injectargs", {"opts": {"osd_pool_default_size": 2,
                                "op_complaint_time": "0.5"}})
    errs = []
    for bad in ({"no_such_option": 1}, {"osd_pool_default_size": "x",
                                        "op_complaint_time": 9.0}):
        with pytest.raises(ValueError) as ei:
            c.handle_config_command("injectargs", {"opts": bad})
        errs.append(str(ei.value))
    out["errs"] = errs
    out["after_refused"] = c.get_val("op_complaint_time")
    out["daemon"] = [c.run_daemon_command(cmd, args, {"status": lambda: 1})
                     for cmd, args in (("config get", {"name": "fsid"}),
                                       ("config get", {"name": "nope"}),
                                       ("status", {}), ("bogus", {}))]
    c.parse_ini("[global]\nosd pool default size = 4\nnot_an_option = 1\n")
    out["ini"] = c.get_val("osd_pool_default_size")
    c.rm_val("osd_pool_default_size")
    out["rm"] = c.get_val("osd_pool_default_size")
    out["seen"] = seen
    out["show"] = c.show_config()
    with pytest.raises(KeyError):
        c.get_val("no_such_option")
    return out


def test_set_val_injectargs_and_observers_equal():
    assert _config_run(pconfig) == _config_run(jconfig)


def test_register_config_observers_drive_levels_and_timer(monkeypatch):
    def run(dout, kt, conf):
        log = dout.Log()
        monkeypatch.setattr(dout, "_log", log)
        timer = kt.KernelTimer()
        monkeypatch.setattr(kt, "g_kernel_timer", timer)
        dout.register_config_observers(conf)
        conf.set_val("debug_osd", "7/12")
        conf.set_val("tracing_kernels", True)
        return log.levels["osd"], timer.enabled
    assert run(pdout, pkt, pconfig.ConfigProxy()) == \
        run(jdout, jkt, jconfig.ConfigProxy()) == ((7, 12), True)


# ---- dout ------------------------------------------------------------------

def _dout_run(mod, monkeypatch):
    log = mod.Log()
    monkeypatch.setattr(mod, "_log", log)
    log.set_level("osd", 2)
    log.parse_level("ec", "3/9")
    log.set_level("newsys", 4, 6)
    d = mod.Dout("osd", "osd.3")
    for lvl in range(8):
        d(lvl, f"osd message {lvl}")
        mod.dlog("ec", lvl, f"ec message {lvl}", who="osd.1")
        mod.dlog("unknown", 0, "dropped")
    entries = [(e.subsys, e.level, e.who, e.msg) for e in log.recent]
    return (log.levels, entries, [d.enabled(n) for n in range(8)],
            [line.split(" ", 1)[1] for line in log.dump_recent(3, "ec")])


def test_dout_levels_and_recent_ring_equal(monkeypatch):
    assert _dout_run(pdout, monkeypatch) == _dout_run(jdout, monkeypatch)
    assert pdout.SUBSYS_DEFAULTS == jdout.SUBSYS_DEFAULTS


# ---- kernel timer ----------------------------------------------------------

def _timer_run(kt, spanmod, monkeypatch):
    tr = spanmod.Tracer()
    monkeypatch.setattr(kt, "_g_tracer", tr)
    t = kt.KernelTimer()
    assert t.timed("off", lambda: 3) == 3 and t.dump() == {}
    t.enable()
    for i in range(4):
        assert t.timed("gf_encode", lambda x: x + 1, i) == i + 1
    with t.time("host_block"):
        pass
    tr.enable()
    root = tr.begin("op", trace_id=5)
    with tr.activate(root):
        t.timed("crush_resolve", lambda: np.zeros(3))
        t.enable(False)
        t.timed("dispatch_only", lambda: None)
    tree = _mask_tree(spanmod.build_tree(tr.collector.spans_for_trace(5)),
                      {})
    return ({n: d["calls"] for n, d in t.dump().items()},
            sorted(next(iter(t.dump().values()))), tree)


def test_kernel_timer_dump_and_spans_equal(monkeypatch):
    assert _timer_run(pkt, pspan, monkeypatch) == \
        _timer_run(jkt, jspan, monkeypatch)


def test_port_profiler_trace_and_annotate(tmp_path):
    assert pkt.start_profiler_trace(str(tmp_path))
    assert not pkt.start_profiler_trace(str(tmp_path))
    with pkt.annotate("bench_phase"):
        np.zeros(4).sum()
    assert pkt.stop_profiler_trace()
    assert not pkt.stop_profiler_trace()
    assert (tmp_path / "trace.json").is_file()


# ---- admin socket and op tracker --------------------------------------------

def _asok_run(mod):
    a = mod.AdminSocket()
    a.register("perf dump", lambda cmd, args: {"cmd": cmd, **args})
    with pytest.raises(KeyError):
        a.register("perf dump", lambda cmd, args: None)
    a.register("config set", lambda cmd, args: (_ for _ in ()).throw(
        ValueError("unrecognized config option 'x'")))
    out = [a.execute("perf dump", {"logger": "osd"}),
           a.execute("perf dump extra words"), a.execute("help"),
           a.execute_json("config set"), a.execute_json("nope")]
    a.unregister("perf dump")
    with pytest.raises(KeyError):
        a.execute("perf dump")
    return out


def test_admin_socket_dispatch_equal():
    import ceph_tpu.common.admin_socket as jasok
    import ceph_tpu_torch.common.admin_socket as pasok
    assert _asok_run(pasok) == _asok_run(jasok)


def _tracker_run(tomod, spanmod, flightmod, journalmod, monkeypatch):
    import importlib
    trace = importlib.import_module(tomod.__name__.rsplit(".", 2)[0]
                                    + ".trace")
    tr = spanmod.Tracer()
    monkeypatch.setattr(trace, "g_tracer", tr)
    monkeypatch.setattr(trace, "g_flight_recorder",
                        flightmod.FlightRecorder())
    j = journalmod.EventJournal()
    monkeypatch.setattr(journalmod, "g_journal", j)
    clock = iter(float(t) for t in range(100))
    ot = tomod.OpTracker(history_size=3, clock=lambda: next(clock),
                         name="osd.4")
    ot.complaint_time = 2.5
    tr.enable()
    ops = []
    for tid in (1, 2, 3, 4):
        root = tr.begin(f"op{tid}", daemon="client", trace_id=tid)
        op = ot.create_request(tid, f"write obj{tid}")
        op.mark_event("queued")
        if tid % 2 == 0:
            op.mark_event("slow_step")
            op.mark_event("slow_step2")
        op.finish()
        tr.finish(root)
        ops.append(op)
    inflight = ot.create_request(9, "read")
    slow = ot.dump_historic_slow_ops()["ops"]
    for d in slow:
        d["span_tree"] = _mask_tree(d.get("span_tree", []), {})
    return (ot.dump_ops_in_flight(), ot.dump_historic_ops(), slow,
            ot.num_slow_ops, [e["type"] for e in j.merged()],
            inflight.duration)


def test_op_tracker_dumps_equal(monkeypatch):
    import ceph_tpu.common.tracked_op as jto
    import ceph_tpu_torch.common.tracked_op as pto
    assert _tracker_run(pto, pspan, pflight, pjournal, monkeypatch) == \
        _tracker_run(jto, jspan, jflight, jjournal, monkeypatch)
