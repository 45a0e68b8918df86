"""The port's lrc plugin against the JAX package's, byte-exact.

Port side: ``ceph_tpu_torch`` plugin ``lrc`` with ``backend=host``; every
layer is a registry codec (jerasure by default) and inherits the backend.
Reference side: ``ceph_tpu``'s ``lrc`` with ``backend=host`` and
``backend=tpu`` (XLA on the CPU).  Tolerance 0.
"""
import itertools
import json

import numpy as np
import pytest

from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu.osd import ecutil as jax_ecutil

from ceph_tpu_torch.crush import constants as port_const
from ceph_tpu_torch.ec import create_erasure_code as port_create
from ceph_tpu_torch.osd import ecutil as port_ecutil

PROFILES = {
    "kml_4_2_3": {"k": "4", "m": "2", "l": "3"},
    "kml_6_3_3": {"k": "6", "m": "3", "l": "3"},
    "kml_locality": {"k": "4", "m": "2", "l": "3", "crush-locality": "rack"},
    # the layered example of Ceph's lrc documentation, one layer on isa
    "explicit": {"mapping": "__DD__DD",
                 "layers": json.dumps([["_cDD_cDD", ""],
                                       ["cDDD____", ""],
                                       ["____cDDD",
                                        "plugin=isa technique=cauchy"]])},
    "explicit_steps": {"mapping": "DD_", "layers": json.dumps([["DDc", ""]]),
                       "crush-steps": json.dumps([["choose", "rack", 2],
                                                  ["chooseleaf", "host", 0]])},
}


def _pair(name, ref_backend="host"):
    prof = {"plugin": "lrc", **PROFILES[name]}
    return (port_create({**prof, "backend": "host"}),
            jax_create({**prof, "backend": ref_backend}))


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_layers_profile_and_sizing(name):
    """The generated mapping, layers and crush-steps, the public profile,
    every layer's delegate and the chunk sizes."""
    port, ref = _pair(name)
    assert port.get_profile() == ref.get_profile()
    assert (port.get_chunk_count(), port.get_data_chunk_count()) == \
        (ref.get_chunk_count(), ref.get_data_chunk_count())
    assert list(port.get_chunk_mapping()) == list(ref.get_chunk_mapping())
    assert [(l.chunks_map, l.data, l.coding, l.profile)
            for l in port.layers] == [(l.chunks_map, l.data, l.coding,
                                       l.profile) for l in ref.layers]
    assert all(l.erasure_code.backend_name == "host" for l in port.layers)
    assert [(s.op, s.type, s.n) for s in port.rule_steps] == \
        [(s.op, s.type, s.n) for s in ref.rule_steps]
    for size in (1, 4096, 65536, 12345):
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_decode_every_pattern(name):
    """encode, then decode / decode_concat of every pattern the JAX
    plugin recovers (minimum_to_decode decides), and the same IOError
    where it does not."""
    port, ref = _pair(name)
    n = port.get_chunk_count()
    payload = np.random.default_rng(n).integers(
        0, 256, 20000, dtype=np.uint8).tobytes()
    enc = port.encode(set(range(n)), payload)
    ref_enc = ref.encode(set(range(n)), payload)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    k = port.get_data_chunk_count()
    want = {port.chunk_index(i) for i in range(k)}
    for e in (1, 2, 3):
        for gone in itertools.combinations(range(n), e):
            avail = set(range(n)) - set(gone)
            try:
                ref_min = ref.minimum_to_decode(want, avail)
            except IOError:
                with pytest.raises(IOError):
                    port.minimum_to_decode(want, avail)
                continue
            assert port.minimum_to_decode(want, avail) == ref_min
            chunks = {i: enc[i] for i in avail}
            assert port.decode_concat(chunks)[:len(payload)] == payload
            try:
                ref_got = ref.decode(set(gone), chunks)
            except IOError:
                with pytest.raises(IOError):
                    port.decode(set(gone), chunks)
                continue
            got = port.decode(set(gone), chunks)
            for i in gone:
                np.testing.assert_array_equal(got[i], ref_got[i])
                np.testing.assert_array_equal(got[i], enc[i])


@pytest.mark.parametrize("name", ["kml_4_2_3", "explicit"])
def test_batch_paths_match_jax_device(name):
    """encode_batch_full and decode_batch, layer by layer through the
    delegates' batched entry points, against the JAX device path."""
    port, ref = _pair(name, "tpu")
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    c = port.get_chunk_size(k * 4096)
    stripes = np.random.default_rng(3).integers(0, 256, (3, k, c),
                                                dtype=np.uint8)
    full = port.encode_batch_full(stripes)
    np.testing.assert_array_equal(full, ref.encode_batch_full(stripes))
    for gone in itertools.combinations(range(n), 2):
        chunks = {i: full[:, i] for i in range(n) if i not in gone}
        try:
            want = ref.decode_batch(chunks, list(gone))
        except IOError:
            with pytest.raises(IOError):
                port.decode_batch(chunks, list(gone))
            continue
        got = port.decode_batch(chunks, list(gone))
        for i in gone:
            np.testing.assert_array_equal(got[i], full[:, i])
            np.testing.assert_array_equal(got[i], want[i])


def test_ecutil_whole_objects():
    port, ref = _pair("kml_4_2_3")
    k, n = 4, 8
    chunk = port.get_chunk_size(k * 4096)
    sp = port_ecutil.stripe_info_t(k, k * chunk)
    sj = jax_ecutil.stripe_info_t(k, k * chunk)
    obj = np.random.default_rng(8).integers(0, 256, 2 * k * chunk,
                                            dtype=np.uint8)
    sh = port_ecutil.encode(sp, port, obj, set(range(n)))
    ref_sh = jax_ecutil.encode(sj, ref, obj, set(range(n)))
    for i in range(n):
        np.testing.assert_array_equal(sh[i], ref_sh[i])
    for gone in ((0,), (0, 5), (1, 3)):
        surv = {i: sh[i] for i in range(n) if i not in gone}
        np.testing.assert_array_equal(
            port_ecutil.decode_concat(sp, port, surv), obj)
        np.testing.assert_array_equal(
            port_ecutil.decode_concat(sp, port, surv),
            jax_ecutil.decode_concat(sj, ref, surv))


def test_minimum_to_decode_prefers_local_layer():
    port, ref = _pair("kml_4_2_3")
    assert port.minimum_to_decode({0}, set(range(1, 8))) == \
        ref.minimum_to_decode({0}, set(range(1, 8)))
    assert set(port.minimum_to_decode({0}, set(range(1, 8)))) == {1, 2, 3}
    with pytest.raises(IOError):
        port.minimum_to_decode({0}, {4, 5, 6, 7})


@pytest.mark.parametrize("name", ["kml_4_2_3", "kml_locality",
                                  "explicit_steps"])
def test_rule_matches_jax_create_rule(name):
    """The port's create_rule adds to the port's CrushWrapper the rule the
    JAX plugin's create_rule adds to the JAX one, step for step; rule_for
    builds the same steps without a map."""
    import ceph_tpu.crush as jax_crush
    import ceph_tpu_torch.crush as port_crush
    port, ref = _pair(name)

    def build(pkg):
        cw = pkg.CrushWrapper()
        cw.set_type_name(1, "host")
        cw.set_type_name(3, "rack")
        cw.set_type_name(10, "root")
        hosts = [cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1, f"host{h}",
                               [2 * h, 2 * h + 1], [0x10000] * 2,
                               id=-(h + 2)) for h in range(8)]
        cw.set_max_devices(16)
        racks = [cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 3, f"rack{r}",
                               hosts[4 * r:4 * r + 4], [0x20000] * 4,
                               id=-(r + 10)) for r in range(2)]
        cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", racks,
                      [0x80000] * 2, id=-1)
        return cw
    cw, pcw = build(jax_crush), build(port_crush)
    rno = ref.create_rule("lrc_rule", cw)
    assert rno >= 0
    want = cw.crush.rules[rno]
    assert port.create_rule("lrc_rule", pcw) == rno
    for got in (pcw.crush.rules[rno],
                port.rule_for(cw.get_item_id("default"), cw.get_type_id)):
        assert [(s.op, s.arg1, s.arg2) for s in got.steps] == \
            [(s.op, s.arg1, s.arg2) for s in want.steps]
        assert (got.type, got.min_size, got.max_size) == \
            (want.type, want.min_size, want.max_size)
        assert got.type == port_const.PG_POOL_TYPE_ERASURE
    assert pcw.crush.rules[rno].ruleset == want.ruleset
    assert pcw.rule_name_map == cw.rule_name_map
    assert port.rule_for(-1, lambda t: -1) is None
    assert port.create_rule("lrc_rule", pcw) == \
        ref.create_rule("lrc_rule", cw) == -17


@pytest.mark.parametrize("bad", [
    {"k": "4", "m": "2", "l": "4"},
    {"k": "4", "m": "2"},
    {"k": "4", "m": "2", "l": "3", "layers": "[]"},
    {"k": "5", "m": "1", "l": "3"},
    {"mapping": "DD_", "layers": "not json"},
    {"mapping": "DD_", "layers": "{}"},
    {"mapping": "DD_", "layers": json.dumps([["DDc_", ""]])},
    {"layers": json.dumps([["DDc", ""]])},
    {"mapping": "DD_", "layers": json.dumps([[1, ""]])},
])
def test_bad_profiles_raise(bad):
    prof = {"plugin": "lrc", "backend": "host", **bad}
    with pytest.raises(ValueError):
        port_create(prof)
    with pytest.raises(ValueError):
        jax_create(prof)
