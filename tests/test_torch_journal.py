"""The port's ``journal/`` against the JAX package's, on the CPU.

Every case of ``tests/test_journal.py`` (append and replay order over the
splay, commit and trim gated on the slowest client, reopen, torn tails,
lifecycle errors, the write-ahead watermark and crash recovery) runs on
both packages with the same inputs: each package's run passes the case's
own assertions, and the journal objects (bodies, xattrs and the
``cls_journal`` metadata omaps on every OSD) are equal between the two.
"""
import pytest

import test_journal as jax_cases
from torch_rbd_twin import (assert_same_runs, case_names, port_module,
                            run_both)

PORT_CASES = port_module(jax_cases)


@pytest.mark.parametrize("name", case_names(jax_cases))
def test_journal_case_equal(name, tmp_path, capsys):
    j, p = run_both(jax_cases, name, tmp_path, capsys, port=PORT_CASES)
    assert len(j.clusters) == 1 and j.states()[0]
    assert_same_runs(j, p)


def test_journal_objects_are_the_ports():
    """The twin runs the port's journal: its module, its object class."""
    import ceph_tpu_torch.journal as pj
    assert PORT_CASES.Journaler is pj.Journaler
    assert PORT_CASES.MiniCluster.__module__ == "ceph_tpu_torch.cluster"
    from ceph_tpu_torch.osd.cls import lookup
    assert lookup("journal", "create") is not None
