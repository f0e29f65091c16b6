"""The unchunked single-end path of rapmap_tpu_torch against rapmap_tpu on
the CPU over the config sweep of tests/test_device_parity.py, plus two
starved budgets: `map_se` (MapOut, counters) and the wire buffer of
`map_batch_se_wire` equal the reference's integer for integer."""

import pytest

from tests.test_torch_quasi import L, assert_unchunked_parity, world  # noqa: F401


@pytest.mark.parametrize(
    "kw",
    [
        dict(consistent_hits=True),
        dict(consistent_hits=True, fuzzy=True),
        dict(quasi_coverage=0.5),
        dict(max_num_hits=2),
        dict(max_interval=4),
        dict(strict_check=True),
        dict(strict_check=True, consistent_hits=True),
        dict(max_out=2, rec_slots=1),          # out_truncated
        dict(expand_budget=1),                 # over_budget
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_unchunked_parity_config_sweep(world, kw):
    idx, sets = world
    kw = dict(dict(max_hits_per_strand=L - idx.k + 1), **kw)
    out, res = assert_unchunked_parity(idx, sets["sweep"], kw)
    if "max_out" in kw:
        assert out.out_truncated.any()
    if kw.get("expand_budget") == 1:
        assert out.over_budget.any()
