"""Paired-end rapmap_tpu_torch against rapmap_tpu on the CPU, integer for
integer, on the world of tests/test_torch_pe.py: `no_orphans` on the read
sets of tests/test_device_parity.py::test_pe_no_orphans and of
tests/test_wire.py's corner cases (unchunked and chunked wire, `map_pe`),
and the other configurations of
tests/test_wire.py::test_wire_pe_direct_merge_corner_cases (unchunked and
chunked wire); each chunked wire also equals the unchunked one, as the
reference's test asks of the reference."""

import numpy as np
import pytest

from tests.test_torch_pe import assert_pe_parity, jax_cache_off, world  # noqa: F401


def test_pe_no_orphans(world):
    idx, sets = world
    out = assert_pe_parity(idx, sets["orphan"], dict(no_orphans=True))
    _, _, po, ctr = out["map_pe"]
    assert not po.any_record.any() and int(ctr.records) == 0
    assert out["chunked"].total == 0


@pytest.mark.parametrize(
    "kw",
    [dict(no_orphans=True), dict(max_frag_len=120, pair_order=True), dict(max_num_hits=1),
     dict(consistent_hits=True)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_pe_direct_merge_corner_cases(world, kw):
    idx, sets = world
    paths = ("unchunked", "chunked", "map_pe") if kw.get("no_orphans") else (
        "unchunked", "chunked")
    out = assert_pe_parity(idx, sets["corner"], kw, paths=paths)
    un, ch = out["unchunked"], out["chunked"]
    assert un.counters == ch.counters and np.array_equal(un.recs, ch.recs)
    assert np.array_equal(un.counts, ch.counts) and np.array_equal(un.flags, ch.flags)
    assert un.total > 0
