"""Paired-end rapmap_tpu_torch against rapmap_tpu on the CPU under the pair
options, integer for integer, on the world and read sets of
tests/test_torch_pe.py: the three configurations of
tests/test_device_parity.py::test_pe_parity_fidelity_constraints
(`max_frag_len`, `pair_order`, both) on its read set, with the unchunked and
the chunked wire and `map_pe`; the constrained merge rejects some pairs,
which then fall back to orphan records."""

import pytest

from tests.test_torch_pe import assert_pe_parity, jax_cache_off, world  # noqa: F401


@pytest.mark.parametrize(
    "kw", [dict(max_frag_len=120), dict(pair_order=True), dict(max_frag_len=100, pair_order=True)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_pe_parity_fidelity_constraints(world, kw):
    idx, sets = world
    out = assert_pe_parity(idx, sets["fidelity"], kw)
    _, _, po, _ = out["map_pe"]
    n = len(sets["fidelity"])
    assert 0 < int(po.concordant[:n].sum()) < n, "constraints should reject some pairs only"
