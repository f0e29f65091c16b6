"""The benchmark's reference: quasi-mapping in plain NumPy, written from
SEMANTICS.md §§1-5 alone.

It shares nothing with the program under test: it starts from the
transcripts the benchmark made (the FASTA's records), concatenates them
itself, and finds k-mer occurrences by scanning that text for the k-mers of
the reads it is asked about, with no suffix array, hash or table of the
program's. An SA interval of the specification is, here, the set of text
positions where the string occurs; the maximal mappable prefix (MMP) of a
read position is the longest prefix of the read from there that occurs, and
its hit is every position where it does.

    ref = Reference(transcripts, k=31)      # [(name, ASCII bytes)], FASTA order
    ref.prepare(reads)                      # every read this reference will map
    ref.map_read(codes)    -> (m, 4) int32  # (t, pos, strand, support)
    ref.map_pair(c1, c2)   -> (m, 7) int32  # (t, p1, s1, has1, p2, s2, has2)

Row layouts are the program's wire records: strand 0 forward, 1 reverse; a
pair record's missing mate has position 0, strand 0 and has = 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# SEMANTICS.md §1: text codes $=0 A=1 C=2 G=3 T=4; read codes A..T=1..4, N=5
_TEXT_CODE = np.zeros(256, np.uint8)
for _ch, _c in zip(b"ACGT", (1, 2, 3, 4)):
    _TEXT_CODE[_ch] = _c
    _TEXT_CODE[_ch + 32] = _c  # lowercase

_BLOCK = 1 << 24  # text positions keyed at a time by the occurrence scan
_FILTER_BITS = 24  # a 16 MiB byte map screens text keys before the exact test
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


@dataclass(frozen=True)
class Semantics:
    """The options of SEMANTICS.md §§3-5 (the command line's flags). Device
    buffer sizes are not among them: they change no answer."""

    k: int = 31
    max_num_hits: int = 200
    max_interval: int = 1000
    consistent_hits: bool = False
    fuzzy: bool = False
    strict_check: bool = False
    quasi_coverage: float = 0.0
    no_orphans: bool = False
    max_frag_len: int = 0
    pair_order: bool = False

    @classmethod
    def of(cls, options: dict) -> "Semantics":
        """From a configuration's map options; refuses the mapping score,
        which this reference does not compute."""
        if options.get("mapping_score"):
            raise ValueError("the reference does not compute mapping scores")
        return cls(**{f: options[f] for f in cls.__dataclass_fields__ if f in options})


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Read codes reverse-complemented: 5 - c for 1..4, anything else 5."""
    c = np.asarray(codes)
    return np.where((c >= 1) & (c <= 4), 5 - c, 5).astype(np.uint8)[::-1]


def window_keys(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (keys uint64, valid bool) of every k-window of a read's codes:
    key = sum (c_i - 1) << 2(k-1-i), valid where all k codes are in 1..4."""
    c = np.asarray(codes, np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    good = (c >= 1) & (c <= 4)
    v = np.where(good, c - 1, 0).astype(np.uint64)
    keys = np.zeros(n, np.uint64)
    for j in range(k):
        keys = (keys << np.uint64(2)) | v[j : j + n]
    bad = np.concatenate([[0], np.cumsum(~good)])
    return keys, (bad[k : k + n] - bad[:n]) == 0


def _text_keys(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """window_keys for a long text block, by doubling: the key of 2^j codes
    from two keys of 2^(j-1), so a k-mer costs log2(k) passes, not k."""
    n = len(codes) - k + 1
    good = codes != 0
    v = np.where(good, codes.astype(np.uint64) - np.uint64(1), np.uint64(0))
    pw = {1: v}
    span = 1
    while 2 * span <= k:
        a = pw[span]
        pw[2 * span] = (a[: len(a) - span] << np.uint64(2 * span)) | a[span:]
        span *= 2
    keys = np.zeros(n, np.uint64)
    at = 0
    for span in sorted(pw, reverse=True):
        if at + span <= k:
            keys = (keys << np.uint64(2 * span)) | pw[span][at : at + n]
            at += span
    bad = np.concatenate([[0], np.cumsum(~good)])
    return keys, (bad[k : k + n] - bad[:n]) == 0


class Reference:
    """Quasi-mapping of SEMANTICS.md over a transcriptome given as records."""

    def __init__(self, transcripts, k: int = 31):
        seen: set[bytes] = set()
        parts, offsets = [], []
        pos = 0
        for _name, seq in transcripts:
            key = bytes(seq).upper()
            if key in seen:  # identical sequences are indexed once (§2)
                continue
            seen.add(key)
            codes = _TEXT_CODE[np.frombuffer(bytes(seq), np.uint8)]
            if not codes.all():
                raise ValueError("the reference takes transcripts of A, C, G and T only")
            parts += [codes, np.zeros(1, np.uint8)]
            offsets.append(pos)
            pos += len(codes) + 1
        self.k = k
        self.n_text = pos
        self.text = np.concatenate(parts + [np.zeros(1024, np.uint8)])
        self.offsets = np.asarray(offsets, np.int64)
        self.occ: dict[int, np.ndarray] = {}

    # ---- occurrences --------------------------------------------------------------

    def prepare(self, reads) -> None:
        """Find every text occurrence of every k-mer of these reads, on both
        strands: one pass over the text, keyed a block at a time."""
        k = self.k
        want = []
        for r in reads:
            for s in (np.asarray(r), revcomp(r)):
                keys, ok = window_keys(s, k)
                want.append(keys[ok])
        want = np.unique(np.concatenate(want)) if want else np.zeros(0, np.uint64)
        screen = np.zeros(1 << _FILTER_BITS, bool)
        screen[self._slot(want)] = True
        found_keys, found_pos = [], []
        for s0 in range(0, self.n_text, _BLOCK):
            block = self.text[s0 : min(self.n_text, s0 + _BLOCK) + k - 1]
            keys, ok = _text_keys(block, k)
            cand = np.flatnonzero(ok & screen[self._slot(keys)])
            if not len(cand):
                continue
            ck = keys[cand]
            at = np.minimum(np.searchsorted(want, ck), len(want) - 1)
            hit = want[at] == ck
            found_keys.append(ck[hit])
            found_pos.append(cand[hit].astype(np.int64) + s0)
        self.occ = {}
        keys = np.concatenate(found_keys) if found_keys else np.zeros(0, np.uint64)
        if len(keys):
            pos = np.concatenate(found_pos)
            order = np.argsort(keys, kind="stable")
            keys, pos = keys[order], pos[order]
            cuts = np.flatnonzero(np.diff(keys)) + 1
            for key, run in zip(keys[np.r_[0, cuts]], np.split(pos, cuts)):
                self.occ[int(key)] = run

    @staticmethod
    def _slot(keys: np.ndarray) -> np.ndarray:
        return ((keys * _GOLDEN) >> np.uint64(64 - _FILTER_BITS)).astype(np.int64)

    # ---- one strand: the SACollector loop (§3) -------------------------------------

    def _mmp(self, where: np.ndarray, read: np.ndarray, pos: int) -> tuple[np.ndarray, int]:
        """The occurrences of the read's longest prefix from `pos` among the
        k-mer's occurrences `where`, and its length (at most L - pos)."""
        k = self.k
        rest = read[pos + k :]
        if not len(rest):
            return where, k
        seg = self.text[where[:, None] + k + np.arange(len(rest))]
        eq = np.concatenate([seg == rest[None, :], np.zeros((len(where), 1), bool)], axis=1)
        run = eq.argmin(axis=1)
        best = int(run.max())
        return where[run == best], k + best

    def scan(self, read: np.ndarray, cfg: Semantics) -> list[tuple[int, int, np.ndarray]]:
        """-> hits [(query position, MMP length, text positions)] of one strand."""
        k, L = self.k, len(read)
        keys, ok = window_keys(read, k)
        hits = []
        pos = 0
        while pos + k <= L:
            if not ok[pos]:
                bad = np.flatnonzero((read[pos : pos + k] < 1) | (read[pos : pos + k] > 4))
                pos += int(bad[0]) + 1
                continue
            where = self.occ.get(int(keys[pos]))
            if where is None or len(where) > cfg.max_interval:
                pos += 1
                continue
            got, length = self._mmp(where, read, pos)
            hits.append((pos, length, got))
            pos += max(1, length - k + 1)
        return hits

    # ---- collation (§4) and the pair merge (§5) -------------------------------------

    def placements(self, hits) -> list[tuple[int, int]]:
        """(t, tpos) of every hit's every text position: tpos = g - offset(t) - q."""
        out = []
        for q, _length, where in hits:
            t = np.searchsorted(self.offsets, where, side="right") - 1
            out += zip(t.tolist(), (where - self.offsets[t] - q).tolist())
        return out

    def vote(self, hits) -> dict[int, tuple[int, int]]:
        """t -> (support, tpos) of one strand: the tpos most hits agree on,
        ties to the smallest, and the number that agree."""
        support: dict[tuple[int, int], int] = {}
        for key in self.placements(hits):
            support[key] = support.get(key, 0) + 1
        best: dict[int, tuple[int, int]] = {}
        for (t, tp), s in support.items():
            cur = best.get(t)
            if cur is None or s > cur[0] or (s == cur[0] and tp < cur[1]):
                best[t] = (s, tp)
        return best

    def mappings(self, read, cfg: Semantics) -> list[tuple[int, int, int, int]]:
        """A read's mappings [(t, pos, strand, support)] ordered by (t,
        strand); [] when unmapped or too ambiguous."""
        read = np.asarray(read, np.uint8)
        L = len(read)
        strands = [self.scan(read, cfg), self.scan(revcomp(read), cfg)]
        if cfg.quasi_coverage > 0.0:
            strands = [h if sum(x[1] for x in h) >= cfg.quasi_coverage * L else []
                       for h in strands]
        out = []
        for strand, hits in enumerate(strands):
            need = len(hits) - (1 if cfg.fuzzy else 0)
            out += [(t, tp, strand, s) for t, (s, tp) in self.vote(hits).items()
                    if not (cfg.consistent_hits and s < need)]
        if cfg.strict_check and out:
            top = [max((m[3] for m in out if m[2] == s), default=0) for s in (0, 1)]
            out = [m for m in out if top[m[2]] == max(top)]
        out.sort(key=lambda m: (m[0], m[2]))
        return [] if len(out) > cfg.max_num_hits else out

    def map_read(self, read, cfg: Semantics) -> np.ndarray:
        return np.asarray(self.mappings(read, cfg), np.int32).reshape(-1, 4)

    def map_pair(self, read1, read2, cfg: Semantics) -> np.ndarray:
        left, right = self.mappings(read1, cfg), self.mappings(read2, cfg)
        by_t: dict[int, list] = {}
        for m in right:
            by_t.setdefault(m[0], []).append(m)
        pairs = []
        for t, p1, s1, _ in left:
            for _, p2, s2, _ in by_t.get(t, []):
                if s1 == s2:
                    continue
                if cfg.max_frag_len and abs(p1 - p2) > cfg.max_frag_len:
                    continue
                if cfg.pair_order and (p1 if s1 == 0 else p2) > (p2 if s1 == 0 else p1):
                    continue
                pairs.append((t, p1, s1, 1, p2, s2, 1))
        if pairs:
            pairs.sort(key=lambda p: (p[0], p[2]))
        elif not cfg.no_orphans:
            pairs = ([(t, p, s, 1, 0, 0, 0) for t, p, s, _ in left]
                     + [(t, 0, 0, 0, p, s, 1) for t, p, s, _ in right])
        if len(pairs) > cfg.max_num_hits:
            pairs = []
        return np.asarray(pairs, np.int32).reshape(-1, 7)
