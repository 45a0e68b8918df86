"""The port's crushtool text and binary map forms against the JAX package's.

- ``CrushCompiler.compile`` / ``decompile``: a straw2 map with tunable lines
  and a choose_args block, and ``chip_smoke.py``'s legacy maps (no tunable
  lines, ``alg straw``, ``set_choose_*`` steps), decompiled byte for byte as
  the JAX compiler does;
- ``decode_crushmap`` / ``encode_crushmap``: the corpus's
  ``CrushWrapper.1.bin``, and maps encoded by the JAX package decoding in the
  port into the same map and re-encoding to the same bytes (the form that
  hands one map to both packages);
- ``dump_json``, ``crush_tree_lines``, ``osd_tree_lines`` and
  ``osd_tree_json`` string for string.

Tolerance: exact equality of text and bytes.
"""
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ceph_tpu.crush import binfmt as jbin
from ceph_tpu.crush import dumpfmt as jdump
from ceph_tpu.crush import treedump as jtree
from ceph_tpu.crush.compiler import CrushCompiler as JaxCompiler
from ceph_tpu.osdmap import simple_build as jsb
from ceph_tpu_torch.crush import binfmt as tbin
from ceph_tpu_torch.crush import dumpfmt as tdump
from ceph_tpu_torch.crush import treedump as ttree
from ceph_tpu_torch.crush.compiler import CrushCompiler
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.osdmap import simple_build as tsb

CORPUS = Path(__file__).resolve().parent / "corpus" / "encodings"


def _straw2_text():
    """A straw2 map with jewel tunables, a device class, uneven weights and
    a choose_args block of two positions."""
    rng = np.random.default_rng(5)
    text = chip_smoke.legacy_text_map(
        2, 3, 2, [["step take default", "step chooseleaf firstn 0 type host",
                   "step emit"],
                  ["step take default", "step chooseleaf indep 0 type host",
                   "step emit"]],
        ("straw2",) * 3,
        tunables=[("choose_local_tries", 0),
                  ("choose_local_fallback_tries", 0),
                  ("choose_total_tries", 50),
                  ("chooseleaf_descend_once", 1),
                  ("chooseleaf_vary_r", 1), ("chooseleaf_stable", 1)])
    text = text.replace("device 3 osd.3", "device 3 osd.3 class ssd")
    ws = " ".join(f"{v:.3f}" for v in rng.integers(1, 9, 2) / 4)
    ws2 = " ".join(f"{v:.3f}" for v in rng.integers(1, 9, 2) / 4)
    return text.replace("# end crush map", (
        "choose_args 0 {\n  {\n    bucket_id -2\n    weight_set [\n"
        f"      [ {ws} ]\n      [ {ws2} ]\n    ]\n    ids [ 100 101 ]\n"
        "  }\n}\n\n# end crush map"))


TEXTS = {"straw2_choose_args": _straw2_text(),
         **{name: text for name, (text, _)
            in chip_smoke.legacy_small_maps().items()}}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_compile_decompile_match_jax(name):
    text = TEXTS[name]
    cw = CrushCompiler().compile(text)
    jcw = JaxCompiler().compile(text)
    out = CrushCompiler(cw).decompile()
    assert out == JaxCompiler(jcw).decompile()
    assert CrushCompiler(CrushCompiler().compile(out)).decompile() == out
    m = cw.crush
    if name != "straw2_choose_args":
        # no tunable lines: the legacy tunables, and none printed back
        assert (m.choose_local_tries, m.choose_local_fallback_tries,
                m.choose_total_tries, m.chooseleaf_descend_once,
                m.chooseleaf_vary_r) == (2, 5, 19, 0, 0)
        assert "tunable choose_local_tries" not in out
    else:
        assert m.choose_args and "choose_args 0 {" in out


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_binary_form_crosses_packages(name):
    """JAX-encoded bytes decode in the port to the same map, which encodes
    back to the same bytes; the port's own encoding equals the JAX one's,
    and the JAX package decodes it to the same text."""
    text = TEXTS[name]
    jblob = jbin.encode_crushmap(JaxCompiler().compile(text))
    cw = tbin.decode_crushmap(jblob)
    assert tbin.encode_crushmap(cw) == jblob
    assert tbin.encode_crushmap(CrushCompiler().compile(text)) == jblob
    assert CrushCompiler(cw).decompile() == JaxCompiler(
        jbin.decode_crushmap(jblob)).decompile()
    m = cw.crush
    rno, size = 0, 3
    w = [0x10000] * m.max_devices
    want = [crush_do_rule(CrushCompiler().compile(text).crush, rno, x, size,
                          w) for x in range(64)]
    assert [crush_do_rule(m, rno, x, size, w) for x in range(64)] == want


def test_corpus_crushwrapper_decodes():
    blob = (CORPUS / "CrushWrapper.1.bin").read_bytes()
    cw = tbin.decode_crushmap(blob)
    jcw = jbin.decode_crushmap(blob)
    assert CrushCompiler(cw).decompile() == JaxCompiler(jcw).decompile()
    assert tbin.encode_crushmap(cw) == jbin.encode_crushmap(jcw)
    assert tdump.dump_json(cw) == jdump.dump_json(jcw)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_dump_and_tree_match_jax(name):
    text = TEXTS[name]
    cw = CrushCompiler().compile(text)
    jcw = JaxCompiler().compile(text)
    assert tdump.dump_json(cw) == jdump.dump_json(jcw)
    assert ttree.crush_tree_lines(cw) == jtree.crush_tree_lines(jcw)
    assert ttree.crush_tree_lines(cw, True) == \
        jtree.crush_tree_lines(jcw, True)


def test_osd_tree_matches_jax():
    """``osd_tree_lines`` / ``osd_tree_json`` on the port's OSDMap, with an
    OSD marked out and one down."""
    m, jm = tsb.build_simple(12), jsb.build_simple(12)
    for osdmap, sb in ((m, tsb), (jm, jsb)):
        sb.mark_up_in(osdmap)
        sb.mark_out(osdmap, 3)
        osdmap.set_osd(5, up=False)
    assert ttree.osd_tree_lines(m) == jtree.osd_tree_lines(jm)
    assert ttree.osd_tree_json(m) == jtree.osd_tree_json(jm)
