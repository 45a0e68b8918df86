"""The port's LRC, SHEC and regenerating (MSR/MBR) codecs against the JAX
package's own cases, on the CPU: profiles and layers, every erasure
pattern, minimum_to_decode, repair contributions and their bytes, and
the batched device paths against the host twin.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions and prints the same output.  Where the port differs
by design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on, or, where it checks
nothing else, is listed in ``torch_case_twin.NOT_RUN``.  The port's
``backend=host`` is its device route with CPU tensors (the kernels' plain
versions), so the LRC device-backend case runs below as a case of its
own against the JAX device route.
"""
import numpy as np
import pytest

import test_lrc
import test_regenerating
import test_shec
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table((test_lrc, test_shec, test_regenerating))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_codec_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_codec_cases_all_twinned():
    assert len(CASES) == 51


def test_lrc_device_route_equals_the_jax_device_route():
    """``test_lrc::test_device_backend_byte_identical`` across the two
    packages: the port's layered code on its device route (CPU tensors)
    against the JAX code on its device route, chunk for chunk, through
    local and global repair and ECUtil's batched encode and degraded
    read."""
    from ceph_tpu.ec import plugin_registry as jreg
    from ceph_tpu.osd import ecutil as jecutil
    from ceph_tpu_torch.ec import plugin_registry as preg
    from ceph_tpu_torch.osd import ecutil as pecutil
    profile = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}
    ref = jreg.factory("lrc", {**profile, "backend": "tpu"})
    port = preg.factory("lrc", {**profile, "backend": "host"})
    assert all(l.erasure_code.torch_device == "cpu" for l in port.layers)
    data = test_lrc.payload(20000, seed=77)
    n = ref.get_chunk_count()
    er, ep = ref.encode(set(range(n)), data), port.encode(set(range(n)),
                                                          data)
    for i in range(n):
        np.testing.assert_array_equal(ep[i], er[i], err_msg=f"chunk {i}")
    for gone in ([0], [1, 4], [2, 6]):
        have = {i: er[i] for i in range(n) if i not in gone}
        dr, dp = ref.decode(set(gone), dict(have)), \
            port.decode(set(gone), dict(have))
        for i in gone:
            np.testing.assert_array_equal(dp[i], dr[i])
    k = ref.get_data_chunk_count()
    w = ref.get_chunk_size(1) * k
    buf = np.frombuffer(data, dtype=np.uint8)
    buf = np.concatenate([buf, np.zeros((-len(buf)) % w, np.uint8)])
    sr = jecutil.encode(jecutil.stripe_info_t(k, w), ref, buf,
                        set(range(n)))
    sp = pecutil.encode(pecutil.stripe_info_t(k, w), port, buf,
                        set(range(n)))
    for i in range(n):
        np.testing.assert_array_equal(sp[i], sr[i], err_msg=f"shard {i}")
    avail = {i: sp[i] for i in range(n) if i not in (0, 5)}
    np.testing.assert_array_equal(
        pecutil.decode_concat(pecutil.stripe_info_t(k, w), port, avail), buf)
