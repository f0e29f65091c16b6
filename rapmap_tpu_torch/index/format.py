"""On-disk index format: flat .npy arrays + header.json (cereal replacement).

Copy of rapmap_tpu.index.format: the quasi and pseudo index types and the
two compact quasi artifacts, the mapping-only one (index_type "quasi_map",
what the host-staged engine maps from) and the core one ("quasi_core",
rebuilt into a full index at load). The directory layout, headers and
content hashes are identical, so an index or artifact written by `tqm`
loads here and one written here loads there.
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
# mapping-only artifact: the minimal set the host-staged engine needs to
# map — no text (only the oracle fallback and the mapping score read it),
# sa/kmer_b narrowed to uint32 where values fit, and interval WIDTHS
# (uint32) instead of the int64 kmer_e column
_QUASI_MAP_ARRAYS = [
    "text2b", "sa", "sa_txp", "sa_tpos",
    "kmer_hi", "kmer_lo", "kmer_b", "kmer_w", "prefix_lut",
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


class _LenOnly:
    """Placeholder for the dropped text array: the staged engine reads only
    len(idx.text) (pad-tail accounting); any element access is a bug."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = int(n)

    def __len__(self) -> int:
        return self.n


class _LazyEnd:
    """kmer_e synthesized as kmer_b + kmer_w on slice access (int64): the
    mapping artifact stores interval WIDTHS in uint32 instead of the second
    int64 slot column."""

    __slots__ = ("b", "w")

    def __init__(self, b: np.ndarray, w: np.ndarray):
        self.b, self.w = b, w

    def __len__(self) -> int:
        return len(self.b)

    def __getitem__(self, sl):
        return (np.asarray(self.b[sl], dtype=np.int64)
                + np.asarray(self.w[sl], dtype=np.int64))


@dataclass
class MappingQuasiIndex:
    """Mapping-only quasi artifact (header index_type "quasi_map"): feeds the
    host-staged engine (parallel/staged.py) exactly; has no text column, so
    the host oracle, the mapping score and the replicated engine need the
    full index. sa/kmer_b are uint32 when values fit (< 2^32); kmer_e is
    synthesized from the stored widths."""

    k: int
    text2b: np.ndarray
    sa: np.ndarray            # uint32 (or int64 when the padded text reaches 2^32)
    sa_txp: np.ndarray        # int32
    sa_tpos: np.ndarray       # int32
    kmer_hi: np.ndarray
    kmer_lo: np.ndarray
    kmer_b: np.ndarray        # uint32 (or int64)
    kmer_w: np.ndarray        # uint32 interval widths
    prefix_lut: np.ndarray
    txp_offsets: np.ndarray
    txp_lens: np.ndarray
    txp_names: list[str]
    n_text: int = 0
    text_len: int = 0         # padded length (pad-tail accounting only)
    prefix_bases: int = 10
    seed: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def n_txps(self) -> int:
        return len(self.txp_lens)

    @property
    def kmer_e(self) -> _LazyEnd:
        return _LazyEnd(self.kmer_b, self.kmer_w)

    @property
    def text(self) -> _LenOnly:
        return _LenOnly(self.text_len)


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


def save_mapping_index(idx: QuasiIndex, outdir: str,
                       chunk_rows: int = 1 << 27) -> dict:
    """Write the mapping-only artifact of `idx` under outdir. Streams the
    width/narrowing conversions in chunk_rows pieces through pre-sized output
    memmaps, so the peak extra RAM is one chunk, not a full int64 temporary.
    Returns {"bytes": total, "per_array": {name: bytes}}."""
    from numpy.lib.format import open_memmap

    os.makedirs(outdir, exist_ok=True)
    sa = idx.sa
    n = len(sa)
    sa_dtype = np.uint32 if len(idx.text) < 2**32 else np.int64
    b_dtype = np.uint32 if n < 2**32 else np.int64

    def _stream(name, src, dtype, second=None):
        out = open_memmap(os.path.join(outdir, f"{name}.npy"), mode="w+",
                          dtype=dtype, shape=(len(src),))
        for i in range(0, len(src), chunk_rows):
            j = min(i + chunk_rows, len(src))
            if second is not None:  # the width second - src
                out[i:j] = (np.asarray(second[i:j], dtype=np.int64)
                            - np.asarray(src[i:j], dtype=np.int64)).astype(dtype)
            else:
                out[i:j] = np.asarray(src[i:j]).astype(dtype, copy=False)
        out.flush()
        h = _sha(np.asarray(out))
        del out
        return h

    hashes = {
        "sa": _stream("sa", sa, sa_dtype),
        "kmer_b": _stream("kmer_b", idx.kmer_b, b_dtype),
        "kmer_w": _stream("kmer_w", idx.kmer_b, np.uint32, second=idx.kmer_e),
    }
    for name in ("text2b", "sa_txp", "sa_tpos", "kmer_hi", "kmer_lo",
                 "prefix_lut", "txp_offsets", "txp_lens"):
        arr = np.asarray(getattr(idx, name))
        np.save(os.path.join(outdir, f"{name}.npy"), arr)
        hashes[name] = _sha(arr)
    _write_names(outdir, idx.txp_names)
    _write_header(outdir, idx, "quasi_map", hashes, np.asarray(idx.sa).dtype == np.int64)
    per = {nm: os.path.getsize(os.path.join(outdir, f"{nm}.npy"))
           for nm in _QUASI_MAP_ARRAYS}
    return {"bytes": sum(per.values()), "per_array": per}


def save_core_index(idx: QuasiIndex, outdir: str,
                    chunk_rows: int = 1 << 27) -> dict:
    """Write the core quasi artifact (header index_type "quasi_core"): only
    the arrays that cannot be re-derived cheaply — the text, the suffix
    array (narrowed to uint32 when the padded text length fits), the
    transcript geometry, and the CHD arrays when present (their placement
    depends on thread order, so they are stored, not re-derived). The k-mer
    interval table, prefix LUT, 2-bit text and sa_txp/sa_tpos are rebuilt at
    load and checked against this header's content hashes, which are taken
    here of the full index's arrays. Returns {"bytes": total, "per_array":
    {name: bytes}}."""
    from numpy.lib.format import open_memmap

    os.makedirs(outdir, exist_ok=True)
    sa = np.asarray(idx.sa)
    sa_stored_dtype = np.uint32 if len(idx.text) < 2**32 else np.int64
    stored = ["text", "sa", "txp_offsets", "txp_lens"]

    out = open_memmap(os.path.join(outdir, "sa.npy"), mode="w+",
                      dtype=sa_stored_dtype, shape=(len(sa),))
    for i in range(0, len(sa), chunk_rows):
        j = min(i + chunk_rows, len(sa))
        out[i:j] = sa[i:j].astype(sa_stored_dtype, copy=False)
    out.flush()
    hashes = {"sa_stored": _sha(np.asarray(out))}
    del out

    for name in ("text", "txp_offsets", "txp_lens"):
        arr = np.asarray(getattr(idx, name))
        np.save(os.path.join(outdir, f"{name}.npy"), arr)
        hashes[name] = _sha(arr)
    for name in _QUASI_OPTIONAL:  # the CHD stored verbatim when built
        arr = getattr(idx, name, None)
        if arr is not None:
            np.save(os.path.join(outdir, f"{name}.npy"), np.asarray(arr))
            hashes[name] = _sha(np.asarray(arr))
            stored.append(name)
    # hashes of everything the loader re-derives, for a bit-exact check
    hashes["sa"] = _sha(sa)
    for name in ("text2b", "sa_txp", "sa_tpos", "kmer_hi", "kmer_lo",
                 "kmer_b", "kmer_e", "prefix_lut"):
        hashes[name] = _sha(np.asarray(getattr(idx, name)))
    _write_names(outdir, idx.txp_names)
    _write_header(outdir, idx, "quasi_core", hashes, sa.dtype == np.int64)
    per = {nm: os.path.getsize(os.path.join(outdir, f"{nm}.npy")) for nm in stored}
    return {"bytes": sum(per.values()), "per_array": per}


def _write_names(outdir: str, names: list[str]) -> None:
    with open(os.path.join(outdir, "txp_names.txt"), "w") as f:
        f.write("\n".join(names) + ("\n" if names else ""))


def _write_header(outdir: str, idx: QuasiIndex, itype: str, hashes: dict,
                  big_sa: bool) -> None:
    """The header of a compact quasi artifact (its key order as tqm's)."""
    header = {
        "format_version": INDEX_FORMAT_VERSION,
        "tool_version": __version__,
        "index_type": itype,
        "k": int(idx.k),
        "n_txps": int(idx.n_txps),
        "seed": int(idx.seed),
        "hashes": hashes,
        "meta": idx.meta,
        "n_text": int(idx.n_text),
        "text_len": int(len(idx.text)),
        "big_sa": bool(big_sa),
        "prefix_bases": int(idx.prefix_bases),
    }
    with open(os.path.join(outdir, "header.json"), "w") as f:
        json.dump(header, f, indent=1)


def _load_core_index(indir: str, header: dict, verify: bool = True) -> QuasiIndex:
    """Rebuild a full QuasiIndex from a quasi_core artifact: re-derive the
    k-mer interval table, prefix LUT, 2-bit text and sa_txp/sa_tpos from
    {text, sa} and (verify=True, the default: the rebuild's correctness is
    the point) check every derived array against the header's content
    hashes from save time."""
    from rapmap_tpu_torch.index.builder import _sa_txp_of
    from rapmap_tpu_torch.index.kmer_table import (
        build_kmer_table, build_prefix_lut, pack_text_2bit,
    )

    hashes = header["hashes"]
    text = np.load(os.path.join(indir, "text.npy"), mmap_mode="r")
    sa_stored = np.load(os.path.join(indir, "sa.npy"), mmap_mode="r")
    if verify:
        for name, arr in (("text", text), ("sa_stored", sa_stored)):
            if _sha(np.asarray(arr)) != hashes[name]:
                raise ValueError(f"core index array {name} failed content-hash validation")
    sa_dtype = np.int64 if header["big_sa"] else np.int32
    sa = np.asarray(sa_stored).astype(sa_dtype, copy=False)
    offsets = np.load(os.path.join(indir, "txp_offsets.npy"))
    lens = np.load(os.path.join(indir, "txp_lens.npy"))
    n_text, k = header["n_text"], header["k"]

    text_arr = np.asarray(text)
    text2b, smask2b = pack_text_2bit(text_arr)
    khi, klo, kb, ke = build_kmer_table(
        text_arr[:n_text], sa, k, packed_smask=(text2b, smask2b)
    )
    lut = build_prefix_lut(khi, klo, k, header["prefix_bases"])
    sa_txp = _sa_txp_of(sa, offsets, lens)
    if sa.dtype == np.int32:
        sa_tpos = sa - offsets.astype(np.int32)[sa_txp]
    else:
        sa_tpos = (sa - offsets[sa_txp]).astype(np.int32)
    if verify:
        derived = {
            "sa": sa, "text2b": text2b, "sa_txp": sa_txp, "sa_tpos": sa_tpos,
            "kmer_hi": khi, "kmer_lo": klo, "kmer_b": kb, "kmer_e": ke,
            "prefix_lut": lut,
        }
        for name, arr in derived.items():
            if _sha(np.ascontiguousarray(arr)) != hashes[name]:
                raise ValueError(
                    f"core index reconstruction of {name} does not match the "
                    f"save-time content hash — refusing to map from it"
                )
    chd = {}
    for name in _QUASI_OPTIONAL:
        p = os.path.join(indir, f"{name}.npy")
        if os.path.exists(p):
            chd[name] = np.load(p, mmap_mode="r")
    with open(os.path.join(indir, "txp_names.txt")) as f:
        txp_names = [ln for ln in f.read().splitlines() if ln]
    return QuasiIndex(
        k=k, text=text, text2b=text2b, sa=sa, sa_txp=sa_txp, sa_tpos=sa_tpos,
        kmer_hi=khi, kmer_lo=klo, kmer_b=kb, kmer_e=ke, prefix_lut=lut,
        txp_offsets=offsets, txp_lens=lens, txp_names=txp_names,
        n_text=n_text, prefix_bases=header["prefix_bases"],
        seed=header["seed"], meta=header.get("meta", {}), **chd,
    )


def load_header(indir: str) -> dict:
    with open(os.path.join(indir, "header.json")) as f:
        header = json.load(f)
    if header["format_version"] != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"index format v{header['format_version']} != supported v{INDEX_FORMAT_VERSION}"
        )
    return header


def load_index(indir: str, mmap: bool = True, verify: bool = False):
    """Load a quasi, pseudo, mapping-only (quasi_map) or core (quasi_core)
    index directory; the mapper dispatches on header index_type. A core
    artifact is rebuilt into a full QuasiIndex and always verified (its
    derived arrays live in RAM whatever `mmap` says)."""
    header = load_header(indir)
    itype = header["index_type"]
    if itype == "quasi_core":
        return _load_core_index(indir, header, verify=True)
    is_quasi = itype == "quasi"
    if itype == "quasi_map":
        names, opt = list(_QUASI_MAP_ARRAYS), []
    else:
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
    if itype == "quasi_map":
        return MappingQuasiIndex(n_text=header["n_text"], text_len=header["text_len"],
                                 prefix_bases=header["prefix_bases"], **arrays, **common)
    if not is_quasi:
        return PseudoIndex(**arrays, **common)
    return QuasiIndex(n_text=header["n_text"], prefix_bases=header["prefix_bases"],
                      **arrays, **common)
