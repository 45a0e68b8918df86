"""The port's ``crushtool.main`` against the JAX package's, command for
command: standard output, return code and every file written must be
equal.

The map is ``chip_smoke.py``'s small legacy rack map (crushtool text with no
tunable lines, so the legacy tunables), compiled by each tool from the same
text.  ``--test`` on it maps on the host ``crush_do_rule`` in both
packages: their testers' card mappers take straw2 maps with bobtail+
tunables only.  The port runs with ``device="cpu"``.

Tolerance: exact equality of text and bytes.
"""
import io

import numpy as np
import pytest

import chip_smoke
from ceph_tpu.tools import crushtool as jtool
from ceph_tpu_torch.tools import crushtool as ttool

TEXT, _ = chip_smoke.legacy_small_maps()["rack3x3x4"]


def _both(argv, tmp_path, capsys, outs=()):
    """Run both tools with ``{d}`` in ``argv`` naming a directory of their
    own holding the compiled map ``map.bin``; return their (rc, stdout,
    files named in ``outs``).  Each tester's default output stream is bound
    when its module is imported, so it is pointed at a buffer here."""
    got = []
    for name, tool, tester in (
            ("jax", jtool.main, jtool.CrushTester),
            ("port", lambda a: ttool.main(a, device="cpu"),
             ttool.CrushTester)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        (d / "map.txt").write_text(TEXT)
        assert tool(["-c", str(d / "map.txt"), "-o", str(d / "map.bin")]) \
            == 0
        capsys.readouterr()
        buf = io.StringIO()
        defaults = tester.__init__.__defaults__
        tester.__init__.__defaults__ = (buf,) + defaults[1:]
        try:
            rc = tool([a.format(d=d) for a in argv])
        finally:
            tester.__init__.__defaults__ = defaults
        out = capsys.readouterr().out + buf.getvalue()
        got.append((rc, out.replace(str(d), "{d}"),
                    [(d / o).read_bytes() for o in outs]))
    return got


def test_compile_writes_the_same_map(tmp_path, capsys):
    (j, p) = _both([], tmp_path, capsys)
    assert (tmp_path / "jax" / "map.bin").read_bytes() == \
        (tmp_path / "port" / "map.bin").read_bytes()
    assert j == p


@pytest.mark.parametrize("argv,outs", [
    (["-d", "{d}/map.bin", "-o", "{d}/map.txt2"], ["map.txt2"]),
    (["-d", "{d}/map.bin"], []),
    (["-i", "{d}/map.bin", "--tree"], []),
    (["-i", "{d}/map.bin", "--dump"], []),
    (["-i", "{d}/map.bin", "--set-choose-local-tries", "0",
      "--set-chooseleaf-vary-r", "1", "-o", "{d}/t.bin"], ["t.bin"]),
    (["-i", "{d}/map.bin", "--set-choose-total-tries", "50"], []),
    (["-i", "{d}/map.bin", "--add-item", "36", "1.0", "osd.36", "--loc",
      "host", "host0", "-o", "{d}/a.bin"], ["a.bin"]),
    (["-i", "{d}/map.bin", "--reweight-item", "osd.5", "0.5", "-o",
      "{d}/r.bin"], ["r.bin"]),
    (["-i", "{d}/map.bin", "--remove-item", "osd.7", "-o", "{d}/x.bin"],
     ["x.bin"]),
    (["-i", "{d}/map.bin", "--show-location", "4"], []),
    (["-i", "{d}/map.bin", "--check", "36"], []),
], ids=["decompile_o", "decompile", "tree", "dump", "set_tunables",
        "set_unsaved", "add_item", "reweight_item", "remove_item",
        "show_location", "check"])
def test_commands_match_jax(argv, outs, tmp_path, capsys):
    j, p = _both(argv, tmp_path, capsys, outs)
    assert p == j


@pytest.mark.parametrize("flags", [
    ["--show-statistics", "--rule", "0", "--num-rep", "3"],
    ["--show-mappings", "--rule", "1", "--num-rep", "4", "--min-x", "100",
     "--max-x", "300"],
    ["--show-bad-mappings", "--rule", "2", "--num-rep", "9", "--max-x",
     "255"],
    ["--show-statistics", "--show-bad-mappings", "--rule", "3",
     "--num-rep", "3", "--max-x", "511", "-w", "3", "0", "-w", "8", "0.25"],
    ["--show-mappings", "--rule", "6", "--num-rep", "3", "--max-x", "99"],
], ids=["statistics", "mappings", "bad_mappings", "weights", "choose_osd"])
def test_test_mode_matches_jax(flags, tmp_path, capsys):
    j, p = _both(["-i", "{d}/map.bin", "--test"] + flags, tmp_path, capsys)
    assert p == j
    assert p[0] == 0 and p[1].strip()


def test_test_mode_rows_are_the_mappers(tmp_path, capsys):
    """``--test --show-mappings`` prints the rows of the port's
    ``LegacyFastRule`` (its plain version here) for the same x."""
    from ceph_tpu_torch.crush.binfmt import decode_crushmap
    from ceph_tpu_torch.ops.crush_legacy import LegacyFastRule
    (_, p) = _both(["-i", "{d}/map.bin", "--test", "--rule", "0",
                    "--num-rep", "3", "--max-x", "255", "--show-mappings"],
                   tmp_path, capsys)
    m = decode_crushmap((tmp_path / "port" / "map.bin").read_bytes()).crush
    out, cnt = LegacyFastRule(m, 0, 3, device="cpu").map_batch(
        np.arange(256, dtype=np.uint32), [0x10000] * m.max_devices)
    want = [f"CRUSH rule 0 x {x} [{','.join(map(str, out[x, :cnt[x]]))}]"
            for x in range(256)]
    assert p[1].splitlines() == want
