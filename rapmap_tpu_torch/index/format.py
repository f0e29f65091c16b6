"""On-disk index format: flat .npy arrays + header.json (cereal replacement).

Copy of rapmap_tpu.index.format for the quasi and pseudo index types; the
directory layout, header and content hashes are identical, so an index
written by `tqm quasiindex` or `tqm pseudoindex` loads here and one written
here loads there. The mapping-only and core artifact types belong to a
later slice.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field

import numpy as np

from rapmap_tpu_torch.version import INDEX_FORMAT_VERSION, __version__

_QUASI_ARRAYS = [
    "text", "text2b", "sa", "sa_txp", "sa_tpos",
    "kmer_hi", "kmer_lo", "kmer_b", "kmer_e", "prefix_lut",
    "txp_offsets", "txp_lens",
]
_PSEUDO_ARRAYS = [
    "kmer_hi", "kmer_lo", "kmer_off", "occ_txp", "occ_pos",
    "txp_offsets", "txp_lens",
]
_QUASI_OPTIONAL = ["chd_dir", "chd_perm", "chd_cls"]
_PSEUDO_OPTIONAL = ["chd_dir", "chd_perm", "chd_cls"]


@dataclass
class QuasiIndex:
    """Host-side view of a quasi index (all numpy; device upload in ops/)."""

    k: int
    text: np.ndarray          # int8 codes, padded with >= pad_tail zeros
    text2b: np.ndarray        # uint32 2-bit packed words
    sa: np.ndarray            # int32 (or int64 for big_sa), len n
    sa_txp: np.ndarray        # int32 per SA slot
    sa_tpos: np.ndarray       # int32 per SA slot: SA[i] - txp_offsets[sa_txp[i]]
    kmer_hi: np.ndarray
    kmer_lo: np.ndarray
    kmer_b: np.ndarray
    kmer_e: np.ndarray
    prefix_lut: np.ndarray
    txp_offsets: np.ndarray   # int64
    txp_lens: np.ndarray      # int32
    txp_names: list[str]
    n_text: int = 0           # unpadded text length
    prefix_bases: int = 10
    seed: int = 0
    meta: dict = field(default_factory=dict)
    # optional CHD perfect hash (meta["chd"] holds seed/m_bits/t_bits and,
    # for canonical-class tables, canonical=True)
    chd_dir: np.ndarray | None = None   # int32 (2^m_bits,)
    chd_perm: np.ndarray | None = None  # int32 (2^t_bits,) kmer row / class id, -1
    chd_cls: np.ndarray | None = None   # int32 (n_cls, 2) [fwd_row, rc_row], -1

    @property
    def n_txps(self) -> int:
        return len(self.txp_lens)


@dataclass
class PseudoIndex:
    """Host-side view of a pseudo index: the k-mer -> (txp, pos) occurrence
    CSR (device upload in models/pseudo.py)."""

    k: int
    kmer_hi: np.ndarray
    kmer_lo: np.ndarray
    kmer_off: np.ndarray      # int64 CSR offsets, len = n_kmers + 1
    occ_txp: np.ndarray       # int32
    occ_pos: np.ndarray       # int32 (txp-local position of k-mer start)
    txp_offsets: np.ndarray
    txp_lens: np.ndarray
    txp_names: list[str]
    seed: int = 0
    meta: dict = field(default_factory=dict)
    # optional canonical-class CHD perfect hash over the k-mer set
    # (meta["chd"]; same structure as the quasi index's)
    chd_dir: np.ndarray | None = None   # int32 (2^m_bits,)
    chd_perm: np.ndarray | None = None  # int32 (2^t_bits,) class id, -1
    chd_cls: np.ndarray | None = None   # int32 (n_cls, 2) [fwd_row, rc_row]

    @property
    def n_txps(self) -> int:
        return len(self.txp_lens)


def index_from_reference(fields: dict, kind: type = QuasiIndex):
    """The reference package's quasi (or, with kind=PseudoIndex, pseudo)
    index, given as a dict of its fields (numpy arrays, scalars, names, meta
    — e.g. `vars(idx)`), as this package's index. The index arrays are this
    system's parameters: this is how one index feeds both packages."""
    kw = {}
    for f in dataclasses.fields(kind):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            v = np.asarray(v)
        elif f.name in ("meta", "txp_names"):
            v = copy.deepcopy(v)
        kw[f.name] = v
    return kind(**kw)


def _sha(arr: np.ndarray) -> str:
    # hash the array buffer in place — tobytes() would copy GBs on
    # production-scale indexes
    return hashlib.sha256(memoryview(np.ascontiguousarray(arr)).cast("B")).hexdigest()[:16]


def save_arrays(outdir: str, arrays: dict) -> dict:
    """Write named arrays as .npy + return their content hashes. Lets the
    builder stream the big non-CHD arrays to disk while the CHD displacement
    search finishes (save_index then skips the already-written names)."""
    os.makedirs(outdir, exist_ok=True)
    hashes = {}
    for name, arr in arrays.items():
        np.save(os.path.join(outdir, f"{name}.npy"), arr)
        hashes[name] = _sha(arr)
    return hashes


def save_index(idx: QuasiIndex | PseudoIndex, outdir: str,
               pre_hashes: dict | None = None) -> None:
    os.makedirs(outdir, exist_ok=True)
    is_quasi = isinstance(idx, QuasiIndex)
    names = list(_QUASI_ARRAYS) if is_quasi else list(_PSEUDO_ARRAYS)
    opt = _QUASI_OPTIONAL if is_quasi else _PSEUDO_OPTIONAL
    names += [n for n in opt if getattr(idx, n, None) is not None]
    hashes = {}
    for name in names:
        if pre_hashes and name in pre_hashes:
            hashes[name] = pre_hashes[name]
            continue
        arr = getattr(idx, name)
        np.save(os.path.join(outdir, f"{name}.npy"), arr)
        hashes[name] = _sha(arr)
    with open(os.path.join(outdir, "txp_names.txt"), "w") as f:
        f.write("\n".join(idx.txp_names) + ("\n" if idx.txp_names else ""))
    header = {
        "format_version": INDEX_FORMAT_VERSION,
        "tool_version": __version__,
        "index_type": "quasi" if is_quasi else "pseudo",
        "k": int(idx.k),
        "n_txps": int(idx.n_txps),
        "seed": int(idx.seed),
        "hashes": hashes,
        "meta": idx.meta,
    }
    if is_quasi:
        header.update(
            n_text=int(idx.n_text),
            big_sa=bool(idx.sa.dtype == np.int64),
            prefix_bases=int(idx.prefix_bases),
        )
    with open(os.path.join(outdir, "header.json"), "w") as f:
        json.dump(header, f, indent=1)


def load_header(indir: str) -> dict:
    with open(os.path.join(indir, "header.json")) as f:
        header = json.load(f)
    if header["format_version"] != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"index format v{header['format_version']} != supported v{INDEX_FORMAT_VERSION}"
        )
    return header


def load_index(indir: str, mmap: bool = True, verify: bool = False):
    """Load a quasi or pseudo index directory (header index_type "quasi" or
    "pseudo"); the mapper dispatches on the type."""
    header = load_header(indir)
    itype = header["index_type"]
    if itype not in ("quasi", "pseudo"):
        raise NotImplementedError(
            f"index type {itype!r}: this slice of rapmap_tpu_torch loads quasi and "
            "pseudo indexes only (quasi_map and quasi_core come with a later slice)"
        )
    is_quasi = itype == "quasi"
    names = list(_QUASI_ARRAYS) if is_quasi else list(_PSEUDO_ARRAYS)
    opt = _QUASI_OPTIONAL if is_quasi else _PSEUDO_OPTIONAL
    names += [n for n in opt if n in header["hashes"]]
    arrays = {}
    mode = "r" if mmap else None
    for name in names:
        arr = np.load(os.path.join(indir, f"{name}.npy"), mmap_mode=mode)
        if verify and _sha(np.asarray(arr)) != header["hashes"][name]:
            raise ValueError(f"index array {name} failed content-hash validation")
        arrays[name] = arr
    with open(os.path.join(indir, "txp_names.txt")) as f:
        txp_names = [ln for ln in f.read().splitlines() if ln]
    common = dict(k=header["k"], txp_names=txp_names, seed=header["seed"],
                  meta=header.get("meta", {}))
    if not is_quasi:
        return PseudoIndex(**arrays, **common)
    return QuasiIndex(n_text=header["n_text"], prefix_bases=header["prefix_bases"],
                      **arrays, **common)
