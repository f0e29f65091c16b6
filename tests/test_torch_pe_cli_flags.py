"""The port's command line on paired-end reads against the reference's (see
tests/test_torch_pe_cli.py) under the pair options and --noUnmapped: equal
SAM apart from @PG and equal --statsJson counters with --noOrphans, with
--maxFragLen and --pairOrder, and with --noUnmapped."""

import pytest

from tests.test_torch_pe_cli import assert_equal_reference, world  # noqa: F401

CASES = {
    "no_orphans": ["--noOrphans", "--batchSize", "16"],
    "max_frag_len_pair_order": ["--maxFragLen", "200", "--pairOrder", "--batchSize", "16"],
    "no_unmapped": ["--noUnmapped", "--batchSize", "16"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_pe_sam_and_stats_equal_reference(world, case):
    want_sam, _ = assert_equal_reference(world, case, CASES[case])
    records = [ln for ln in want_sam if ln[0] != "@"]
    if case == "no_orphans":  # no record of a mapped mate beside an unmapped one
        assert not any(int(ln.split("\t")[1]) & 0x8 and not int(ln.split("\t")[1]) & 0x4
                       for ln in records)
    if case == "no_unmapped":
        assert not any("\t77\t*\t" in ln for ln in records)
