"""Paired-end rapmap_tpu_torch against rapmap_tpu on the CPU, integer for
integer, on the draws of two seeds of
tests/test_device_parity.py::test_pe_parity_fuzz (index shape, k, mate
length, noise, orphan and unmapped mates, pair options, all from the seed):
the unchunked and the chunked wire and `map_pe`."""

import numpy as np
import pytest

from tests.test_torch_pe import assert_pe_parity, jax_cache_off  # noqa: F401
from tests.util import BASES, toy_index


def fuzz_draws(tmp_path, seed):
    """The index, pairs and options test_pe_parity_fuzz draws from `seed`."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(9, 14))
    idx, txps = toy_index(
        tmp_path, rng, n_txps=int(rng.integers(4, 8)),
        min_len=250, max_len=int(rng.integers(300, 600)), k=k,
    )
    comp = bytes.maketrans(b"ACGT", b"TGCA")

    def noisy(seq):
        b = bytearray(seq)
        for j in range(len(b)):
            r = rng.random()
            if r < 0.02:
                b[j] = BASES[int(rng.integers(0, 4))]
            elif r < 0.03:
                b[j] = ord("N")
        return bytes(b)

    L = int(rng.integers(k + 5, 60))
    pairs = []
    for _ in range(int(rng.integers(10, 20))):
        t = int(rng.integers(0, len(txps)))
        seq = txps[t][1]
        frag = int(rng.integers(2 * L, min(len(seq), 4 * L)))
        p1 = int(rng.integers(0, len(seq) - frag + 1))
        left = noisy(seq[p1 : p1 + L])
        right = noisy(seq[p1 + frag - L : p1 + frag].translate(comp)[::-1])
        if rng.random() < 0.15:
            right = BASES[rng.integers(0, 4, L)].tobytes()  # orphan
        pairs.append((left, right))
    pairs.append((BASES[rng.integers(0, 4, L)].tobytes(),) * 2)

    kw = {}
    if rng.random() < 0.4:
        kw["max_frag_len"] = int(rng.integers(2 * L, 5 * L))
    if rng.random() < 0.4:
        kw["pair_order"] = True
    if rng.random() < 0.3:
        kw["no_orphans"] = True
    return idx, pairs, kw, L


@pytest.mark.parametrize("seed", [505, 606])
def test_pe_parity_fuzz(tmp_path, seed):
    idx, pairs, kw, L = fuzz_draws(tmp_path, seed)
    # the budgets of tests/test_device_parity.py::parity_cfg
    kw.update(expand_budget=2048, max_out=256)
    out = assert_pe_parity(idx, pairs, kw, pad_to=24, pad_len=L)
    assert out["unchunked"].counters["reads_mapped"] > 0
