#!/usr/bin/env python3
"""Time the anchor-walk kernel (rapmap_tpu_torch/csrc/walk.cu) against
simpler forms of itself on one CUDA card.

    python3 scripts/walk_ablation.py [--parent DIR] [--rounds 2] [--seed 0]
    python3 scripts/walk_ablation.py --k8 [--parent DIR] [--rounds 3] [--seed 0]
    python3 scripts/walk_ablation.py --k10 [--parent DIR] [--rounds 3] [--seed 0]

Builds walk.cu as it stands (`as_is`) and with a design item swapped in or
out, each a text edit of the source that must apply exactly once:

  interleaved   the equal range's two searches interleaved, one trip of each
                per pass so that two row loads are in flight (tried, slower,
                not kept);
  global_words  query words and sa_cmp fields loaded from global memory
                where a compare uses them (4-byte loads), not into registers
                ahead of the compare: the anchor masks and the staged output
                alone;
  interleaved_global_words  both.

With --parent DIR it also builds DIR/rapmap_tpu_torch/csrc/walk.cu and times
it beside the others: a walk kernel of the anchor-mask interface, as this
one, or of the older interface that takes the lane-aligned anchor tables
(db2, de2, anc2 of ops/mmp.py anchor_tables) and a zero-filled hit buffer,
whose fill (`torch.zero_`) is then timed beside it.

Every build is checked against anchor_walk_plain on the smoke chunk of
chip_smoke.py's world (16,384 lanes of 76 bp, H = 16), on outputs that start
as 0xFF bytes. Then each launch is timed on the device under torch.profiler,
warm (100 launches back to back) and cold (50 launches, each after a 1 GiB
fill that evicts the L2), the builds in turn and in reverse turn for each
round. The other two builds of the kernel are timed the same way for this
walk.cu and the parent's (the text edits touch neither): the charwise build
(tqm_anchor_walk_charwise, strand-paired lanes of the same chunk on the full
upload, against anchor_walk_plain with the plain _extend) and the pseudo
build (tqm_pseudo_walk on the same chunk's intervals and masks, against
pseudo_walk_plain). Prints one JSON line; the card's name and power limit
are in it.

--k8 times the sharded walks (K8, tqm_sharded_walk) instead. It builds
walk.cu as it stands and with the sharded build's block size or owner
search swapped, by text edits as above:

  lanes32, lanes128  32 or 128 lanes a block (64 as it stands; only the
                     sharded build is timed);
  linear_owner       the owner found by a scan over every shard's offset,
                     not by binary lifting;
  speculative_query  the lane's query words and next_bad entry loaded
                     before its owner is known, also by a lane no shard
                     owns (as it stands, an unowned lane loads nothing);
  speculative_query_linear_owner  both;

and with --parent DIR that checkout's walk.cu (any walk.cu with the same
tqm_sharded_walk entry, such as the per-shard loop this design replaced).
On chip_smoke.py's world cut into its 4 shards, it times the sharded entry
at one data row's program (16,384 reads: 32,768 lanes) and at one chunk
(8,192 reads), on strand-paired lanes (canonical-class shards) and on
explicit lanes (per-strand CHD shards); for this walk.cu and the parent's
also over a one-shard stack of the world's index (the replicated upload)
at both shapes. In the same call it times this walk.cu's and the parent's
other builds on the chunk: the packed walk (tqm_anchor_walk) on
strand-paired and on explicit lanes, the charwise and pseudo builds, and
the anchor-parallel extension (tqm_extend_packed_lanes, K9) at the staged
path's shape (shard 0 of 8, A_max anchor slots of a 32,768-read batch).
Each launch is first checked on 0xFF-filled outputs against its plain
version (sharded_walk_plain, anchor_walk_plain, anchor_walk_lanes_plain,
pseudo_walk_plain, extend_packed); then all are timed warm and cold, in
turn and in reverse turn for each round. The JSON line also carries nvcc's
-Xptxas -v lines (registers, spills) for every anchor_walk_kernel
instantiation of this walk.cu and the parent's.

--k10 times one shard's trip of the split sharded walk (K10,
tqm_sharded_trip) instead: walk.cu as it stands and, by text edits as
above,

  no_prefetch        without the owned lane's prefetch of its first row;
  lanes64, lanes128  64 or 128 lanes a block (256 as it stands);
  compacted          256-lane blocks that store their zeros first and
                     extend a shared-memory list of their owned lanes on
                     their first threads (tried, slower, not kept);

and, with --parent DIR, that checkout's walk.cu (any walk.cu with the same tqm_sharded_trip
entry, such as the one-thread-a-lane form this design replaced). On
chip_smoke.py's world cut into its 4 shards, each uploaded on its own
(split_idx=True), one data row's program (16,384 reads: 32,768 lanes)
runs through the plain trip loop, which records each trip's inputs; every
build is checked on 0xFF-filled outputs against sharded_trip_plain and
timed at the program's first trip, its second (trip 1) and its first trip
with no active lane, on each of the 4 shards, warm and cold, in turn and
in reverse turn for each round. The JSON line carries the means over the
shards a trip and build, and nvcc's -Xptxas -v lines for the
sharded_trip_kernel instantiations of this walk.cu and the parent's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- the simpler forms, as edits of walk.cu: (start marker, end marker, text
# ---- that replaces the source from the start marker up to the end marker)

INTERLEAVED = (
    "// Binary search in [lo, hi)",
    "// One trip's extension on the sharded index",
    """// Binary search in [lo, hi) for the first S_p >= Q, with the lcps of the
// last "less" and the last "not less" compare.
template <bool kCount>
__device__ int64_t lower_bound(const Index& ix, const Query& q, int qlen, int64_t lo, int64_t hi,
                               int steps, int& ll, int& lg, const Traffic& tr) {
  ll = 0;
  lg = 0;
  for (int t = 0; t < steps && lo < hi; ++t) {
    const int64_t mid = (lo + hi) >> 1;
    const Row row = load_row<kCount>(ix, mid, q.W, tr);
    int cmp, lcp;
    suffix_cmp<kCount>(ix, q, row, qlen, cmp, lcp, tr);
    if (cmp < 0) {
      ll = lcp;
      lo = mid + 1;
    } else {
      lg = lcp;
      hi = mid;
    }
  }
  return lo;
}

// The equal range: the first S_p >= Q in [lo1, hi1) and the first S_p > Q in
// [lo2, hi2), one trip of each per pass so that their row loads overlap.
template <bool kCount>
__device__ void equal_range(const Index& ix, const Query& q, int qlen, int64_t& lo1, int64_t hi1,
                            int64_t& lo2, int64_t hi2, int steps, const Traffic& tr) {
  for (int t = 0; t < steps && (lo1 < hi1 || lo2 < hi2); ++t) {
    const bool a1 = lo1 < hi1;
    const bool a2 = lo2 < hi2;
    const int64_t m1 = (lo1 + hi1) >> 1;
    const int64_t m2 = (lo2 + hi2) >> 1;
    Row r1{}, r2{};
    if (a1) r1 = load_row<kCount>(ix, m1, q.W, tr);
    if (a2) r2 = load_row<kCount>(ix, m2, q.W, tr);
    int cmp, lcp;
    if (a1) {
      suffix_cmp<kCount>(ix, q, r1, qlen, cmp, lcp, tr);
      if (cmp < 0) lo1 = m1 + 1; else hi1 = m1;
    }
    if (a2) {
      suffix_cmp<kCount>(ix, q, r2, qlen, cmp, lcp, tr);
      if (cmp <= 0) lo2 = m2 + 1; else hi2 = m2;
    }
  }
}

template <bool kCount>
__device__ void extend_lane(const Index& ix, const int64_t* words, const int64_t* nbad,
                            int64_t len, int64_t col_off, int64_t b0, int64_t e0,
                            int64_t pos, bool active, int k, int steps, int L, int W,
                            int64_t& b, int64_t& e, int64_t& mlen, const Traffic& tr) {
  Query q;
  q.words = words;
  q.base = pos + k + col_off;
  q.L = L;
  q.W = W;
  const int64_t end = len + col_off;
  load_query(q, static_cast<int>(clamp64(end - q.base, 0, L - k)));
  const int64_t nb =
      q.base < L ? load<kCount>(tr, kNextBad, nbad + clamp64(q.base, 0, L - 1)) : q.base;
  const int qlen = static_cast<int>(clamp64((nb < end ? nb : end) - q.base, 0, L - k));
  const int64_t b0a = active ? b0 : 0;
  const int64_t e0a = active ? e0 : 0;
  int ll, lg;
  const int64_t lb = lower_bound<kCount>(ix, q, qlen, b0a, e0a, steps, ll, lg, tr);
  const int l_left = lb > b0a ? ll : 0;
  const int l_right = lb < e0a ? lg : 0;
  int ext = l_left > l_right ? l_left : l_right;
  ext = ext < qlen ? ext : qlen;
  int64_t lb2 = l_left < ext ? lb : b0a;
  int64_t ub2 = lb;
  equal_range<kCount>(ix, q, ext, lb2, lb, ub2, l_right < ext ? lb : e0a, steps, tr);
  const bool ok = active && ub2 > lb2;
  b = ok ? lb2 : b0;
  e = ok ? ub2 : e0;
  mlen = ok ? k + ext : k;
}

""",
)

GLOBAL_WORDS = (
    "// One lane's query:",
    "// Binary search in [lo, hi)",
    """// One lane's query: the read suffix beyond depth k at column `base`.
struct Query {
  const int64_t* words;
  int64_t base;
  int L;
  int W;
};

template <bool kCount>
__device__ __forceinline__ uint32_t query_word(const Query& q, int j, const Traffic& tr) {
  const int64_t c = q.base + 16 * j;
  if (c >= q.L) return 0u;
  return static_cast<uint32_t>(load<kCount>(tr, kPreads, q.words + clamp64(c, 0, q.L - 1)));
}

__device__ __forceinline__ void load_query(Query&, int) {}

struct Row {
  const int32_t* p;
};

template <bool kCount>
__device__ __forceinline__ Row load_row(const Index& ix, int64_t slot, int, const Traffic& tr) {
  if constexpr (kCount) atomicAdd(tr.rows, 1ull);
  return Row{ix.sa_cmp + clamp64(slot, 0, ix.n_sa - 1) * (3 + ix.F)};
}

template <bool kCount>
__device__ __forceinline__ uint32_t raw_text_word(const Index& ix, int64_t wi0, int i,
                                                  const Traffic& tr) {
  const int64_t row = clamp64(wi0 + 4 * (i >> 2), 0, ix.nw - 1);
  return static_cast<uint32_t>(load<kCount>(tr, kText2q, ix.text2q + row * 4 + (i & 3)));
}

template <bool kCount>
__device__ uint32_t text_word(const Index& ix, const Row& row, int j, const Traffic& tr) {
  if (j < ix.F) return static_cast<uint32_t>(load<kCount>(tr, kSaCmp, row.p + 3 + j));
  const int64_t wi = load<kCount>(tr, kSaCmp, row.p);
  const int sh = load<kCount>(tr, kSaCmp, row.p + 1) << 1;
  const uint32_t r0 = raw_text_word<kCount>(ix, wi + ix.F, j - ix.F, tr);
  if (sh == 0) return r0;
  const uint32_t r1 = raw_text_word<kCount>(ix, wi + ix.F, j - ix.F + 1, tr);
  return (r0 << sh) | (r1 >> (32 - sh));
}

__device__ __forceinline__ bool cmp_word(uint32_t qw, uint32_t tw, int qlen, int tleft, int j,
                                         int& cmp, int& lcp) {
  int qn = qlen - 16 * j;
  qn = qn < 0 ? 0 : (qn > 16 ? 16 : qn);
  int tn = tleft - 16 * j;
  tn = tn < 0 ? 0 : (tn > 16 ? 16 : tn);
  const int n = qn < tn ? qn : tn;
  const uint32_t mask = n == 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * n));
  const uint32_t qv = qw & mask;
  const uint32_t tv = tw & mask;
  const int diffpos = __clz(static_cast<int>(qv ^ tv)) >> 1;
  const bool has_diff = diffpos < n;
  lcp += has_diff ? diffpos : n;
  if (has_diff || tn < qn || qn < 16) {
    cmp = has_diff ? (tv < qv ? -1 : 1) : (tn < qn ? -1 : 0);
    return true;
  }
  return false;
}

template <bool kCount>
__device__ __forceinline__ void suffix_cmp(const Index& ix, const Query& q, const Row& row,
                                           int qlen, int& cmp, int& lcp, const Traffic& tr) {
  cmp = 0;
  lcp = 0;
  const int tleft = load<kCount>(tr, kSaCmp, row.p + 2);
  for (int j = 0; j < q.W; ++j) {
    const bool used = 16 * j < qlen && 16 * j < tleft;
    const uint32_t tw = used ? text_word<kCount>(ix, row, j, tr) : 0u;
    const uint32_t qw = used ? query_word<kCount>(q, j, tr) : 0u;
    if (cmp_word(qw, tw, qlen, tleft, j, cmp, lcp)) return;
  }
}

""",
)

VARIANTS = {
    "as_is": (),
    "interleaved": (INTERLEAVED,),
    "global_words": (GLOBAL_WORDS,),
    "interleaved_global_words": (INTERLEAVED, GLOBAL_WORDS),
}

# ---- forms of the sharded build (--k8)


def block_lanes(n: int):  # every build's lanes a block; only the sharded one is timed
    return ("constexpr int kMaxLanes = 64;", "constexpr int kMaxShards",
            f"constexpr int kMaxLanes = {n};\n")


LINEAR_OWNER = (
    "  int p = 0;\n  for (int step = sh.top;",
    "  const int64_t base = table[2 * p];",
    """  int p = 0;
  for (int q = 1; q < sh.P; ++q) p = table[2 * q] <= b0 ? q : p;
""",
)

# the query words and next_bad entry loaded whether or not the lane's shard
# owns its anchor, so that they need not wait for the owner search
SPECULATIVE_QUERY = (
    "  load_query(q, active ?",
    "  const int qlen =",
    """  load_query(q, static_cast<int>(clamp64(end - q.base, 0, L - k)));
  const int64_t nb =
      q.base < L ? load<kCount>(tr, kNextBad, nbad + clamp64(q.base, 0, L - 1)) : q.base;
""",
)

K8_VARIANTS = {
    "as_is": (),
    "lanes32": (block_lanes(32),),
    "lanes128": (block_lanes(128),),
    "linear_owner": (LINEAR_OWNER,),
    "speculative_query": (SPECULATIVE_QUERY,),
    "speculative_query_linear_owner": (SPECULATIVE_QUERY, LINEAR_OWNER),
}


# ---- forms of the sharded trip (--k10)

def trip_lanes(n: int):  # K10's lanes a block (256 as it stands)
    return ("constexpr int kTripLanes = 256;", "constexpr int kAdvanceLanes",
            f"constexpr int kTripLanes = {n};\n")


# the owned-lane prefetch of the first compared row left out
NO_PREFETCH = (
    "    if (lb < le) {  // the first compare's row",
    "    extend_lane<kCount>(ix, preads + r * L, next_bad + r * L, len, off,",
    "",
)

# blocks of 256 lanes that store their zeros first, compact their owned lanes
# into a shared-memory list (a warp ballot, a prefix over the warps' counts)
# and extend them on the block's first threads; a block with none exits
# (tried, slower, not kept)
COMPACTED = (
    "// One shard's term of one trip of the sharded walk (K10, the split path;",
    "// The split walk's trip at home (K11;",
    """// n int64 zeros from p, stored by the block's threads together: 16 bytes a
// store, neighbouring threads on neighbouring addresses, where p is 16-byte
// aligned.
__device__ __forceinline__ void zero_span(int64_t* p, int n) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    longlong2* v = reinterpret_cast<longlong2*>(p);
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) v[i] = make_longlong2(0, 0);
    if ((n & 1) && threadIdx.x == 0) p[n - 1] = 0;
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0;
  }
}

// One shard's term of one trip of the sharded walk (K10, the split path;
// rapmap_tpu/parallel/sharded.py _sharded_scan_paired :583-600 and
// _sharded_scan :433-451 on one idx shard, up to the psums): lane r is the
// shard's when it is active and its GLOBAL b0 lies in [base, base +
// n_local), n_local the true slot count, tested before the rebase; it
// extends over the shard's rows at local slots (extend_lane, as K8 does on
// the owner it finds) and writes (b + base, e + base, mlen), and every other
// lane (0, 0, 0) without reading its row. A block of kTripLanes lanes writes
// its zeros first, compacts its owned lanes into a list in lane order (a
// warp's ballot, a prefix over the warps' popcounts) and extends them on its
// first threads; a block that owns no lane exits after its stores. Every
// output byte is written.
template <bool kCount>
__global__ void __launch_bounds__(kTripLanes) sharded_trip_kernel(
    const int64_t* __restrict__ preads, const int64_t* __restrict__ next_bad,
    const int64_t* __restrict__ lens2, const int64_t* __restrict__ col_off2,
    const int64_t* __restrict__ b0, const int64_t* __restrict__ e0,
    const int64_t* __restrict__ pos, const uint8_t* __restrict__ active, Index ix, int64_t base,
    int64_t n_local, int64_t R, int L, int k, int steps, int W, int64_t* __restrict__ b_out,
    int64_t* __restrict__ e_out, int64_t* __restrict__ mlen_out, Traffic tr) {
  __shared__ int owned[kTripLanes];         // the owned lanes, offsets from r0, in lane order
  __shared__ int64_t owned_lb[kTripLanes];  // their b0 - base
  __shared__ int warp_owned[kTripLanes / 32];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTripLanes;
  const int nl = static_cast<int>(R - r0 < kTripLanes ? R - r0 : kTripLanes);
  zero_span(b_out + r0, nl);
  zero_span(e_out + r0, nl);
  zero_span(mlen_out + r0, nl);
  const int t = threadIdx.x;
  int64_t lb = -1;
  if (t < nl) {
    touch<kCount>(tr, kActive, active + r0 + t, 1);
    if (active[r0 + t] != 0) lb = load<kCount>(tr, kB0, b0 + r0 + t) - base;
  }
  const bool mine = lb >= 0 && lb < n_local;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, mine);
  const int warp = t >> 5;
  const int lane = t & 31;
  if (lane == 0) warp_owned[warp] = __popc(ballot);
  __syncthreads();  // also orders the zero stores before the owned lanes' results
  int before = 0, total = 0;
  for (int w = 0; w < kTripLanes / 32; ++w) {
    const int c = warp_owned[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (total == 0) return;  // the same total in every thread of the block
  if (mine) {
    const int i = before + __popc(ballot & ((1u << lane) - 1u));
    owned[i] = t;
    owned_lb[i] = lb;
  }
  __syncthreads();
  if (t < total) {  // total <= kTripLanes: one owned lane a thread
    const int64_t r = r0 + owned[t];
    int64_t b, e, mlen;
    extend_lane<kCount>(ix, preads + r * L, next_bad + r * L, load<kCount>(tr, kLens, lens2 + r),
                        load<kCount>(tr, kColOff, col_off2 + r), owned_lb[t],
                        clamp64(load<kCount>(tr, kE0, e0 + r) - base, 0, n_local),
                        load<kCount>(tr, kPos, pos + r), true, k, steps, L, W, b, e, mlen, tr);
    b_out[r] = b + base;
    e_out[r] = e + base;
    mlen_out[r] = mlen;
  }
}

""",
)

K10_VARIANTS = {
    "as_is": (),
    "no_prefetch": (NO_PREFETCH,),
    "lanes64": (trip_lanes(64),),
    "lanes128": (trip_lanes(128),),
    "compacted": (COMPACTED,),
}


def edit(src: str, edits) -> str:
    for start, end, text in edits:
        if src.count(start) != 1 or src.count(end) != 1:
            raise RuntimeError(f"walk.cu no longer has one {start!r} and one {end!r}")
        a, b = src.index(start), src.index(end)
        src = src[:a] + text + src[b:]
    return src


def start_builds(sources: dict, out: str, verbose=()) -> dict:
    """One nvcc per source, all at once (with -Xptxas -v for the names in
    `verbose`) -> {name: process}."""
    from rapmap_tpu_torch import kernels

    return {n: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *(["-Xptxas", "-v"] if n in verbose else []),
         "-o", os.path.join(out, f"{n}.so"), p],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n, p in sources.items()}


def finish_builds(procs: dict, out: str) -> tuple[dict, dict]:
    """Wait for the builds -> ({name: loaded library}, {name: compiler log})."""
    logs = {}
    for n, p in procs.items():
        logs[n], _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"nvcc {n} failed:\n{logs[n]}")
    return {n: ctypes.CDLL(os.path.join(out, f"{n}.so")) for n in procs}, logs


def walk_registers(log: str, kernel: str = "anchor_walk_kernel") -> dict:
    """ptxas's lines for each instantiation of `kernel` in an nvcc
    -Xptxas -v log -> {kernel (demangled where cu++filt is found): "Used N
    registers, ...; ... spill stores, ... spill loads"}."""
    from rapmap_tpu_torch import kernels

    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
        elif cur and ("spill stores" in line or "Used " in line):
            found.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    names = list(found)
    filt = os.path.join(os.path.dirname(kernels._nvcc()), "cu++filt")
    if names and os.path.exists(filt):
        out = subprocess.run([filt, *names], capture_output=True, text=True).stdout.split("\n")
        names = [d or n for n, d in zip(names, out + [""] * len(names))]
    return {d: "; ".join(v) for d, v in zip(names, found.values())}


def entry(lib, name: str, argtypes: list, args: list):
    """A launcher of one C entry on the current stream, raising on a CUDA
    error."""
    import torch

    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        if fn(*args, stream):
            raise RuntimeError(f"{name}: launch failed")
    return go


VP, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def walk_outputs(R: int, H: int, dev):
    """A walk's outputs (hits (R, H, 4) int64, n (R,) int64, truncated (R,)
    one byte each) and the 0xFF byte each is filled with before a check."""
    import torch

    return ((torch.empty((R, H, 4), dtype=torch.int64, device=dev), -1),
            (torch.empty((R,), dtype=torch.int64, device=dev), -1),
            (torch.empty((R,), dtype=torch.uint8, device=dev), 0xFF))


def hits_of(outs):
    buf, n, trunc = (t for t, _ in outs)
    return (buf[..., 0], buf[..., 1], buf[..., 2], buf[..., 3], n, trunc.bool())


def walk_entry(lib, didx, w, prm: dict, outs, paired: bool):
    """tqm_anchor_walk (the packed build) on walk inputs w of either lane kind."""
    from rapmap_tpu_torch.ops.extend_packed import ext_words

    R, L = w.preads.shape
    k = prm["k"]
    args = [*(t.data_ptr() for t in w), didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0],
            didx.sa_cmp.shape[1] - 3, didx.text2q.data_ptr(), didx.text2q.shape[0], R,
            R // 2 if paired else R, L, w.bf.shape[1], k, prm["H"], prm["ext_steps"],
            ext_words(L, k), *(t.data_ptr() for t, _ in outs)]
    types = [VP] * 11 + [I64, I32, VP, I64, I64, I64] + [I32] * 6 + [VP] * 3
    return entry(lib, "tqm_anchor_walk", types, args)


def charwise_entry(lib, fdidx, w, codes, prm: dict, outs):
    """tqm_anchor_walk_charwise on strand-paired lanes over the full upload."""
    R, L = codes.shape
    args = [codes.data_ptr(), *(t.data_ptr() for t in lane_tensors(w)),
            fdidx.sa.data_ptr(), fdidx.sa.shape[0], fdidx.text.data_ptr(), fdidx.text.shape[0],
            R, R // 2, L, w.bf.shape[1], prm["k"], prm["H"], prm["ext_steps"],
            *(t.data_ptr() for t, _ in outs)]
    types = [VP] * 9 + [I64, VP, I64, I64, I64] + [I32] * 5 + [VP] * 3
    return entry(lib, "tqm_anchor_walk_charwise", types, args)


def pseudo_entry(lib, w, k: int, H: int, outs):
    """tqm_pseudo_walk on the strand-paired lanes' intervals and masks."""
    R = w.lens2.shape[0]
    args = [*(t.data_ptr() for t in lane_tensors(w)), R, R // 2, w.bf.shape[1], k, H,
            *(t.data_ptr() for t, _ in outs)]
    return entry(lib, "tqm_pseudo_walk", [VP] * 7 + [I64, I64] + [I32] * 3 + [VP] * 3, args)


def lane_tensors(w):
    """What the charwise and pseudo builds read of a walk's inputs."""
    return [w.lens2, w.bf, w.ef, w.br, w.er, w.anch_f, w.anch_rF]


def kernel_ms(work, key):
    """Mean device ms of the kernels whose name holds `key` in work(), under
    torch.profiler; a profiled window that recorded none of them (the
    profiler now and then drops every device event of one) runs again,
    three times at most."""
    import chip_smoke as cs

    for _ in range(3):
        v = [v for n, v in cs.device_kernels(work).items() if key in n]
        if v:
            return sum(x[0] for x in v) / sum(x[1] for x in v)
    raise RuntimeError(f"torch.profiler recorded no {key} kernel in three tries")


def time_round(gos: dict, res: dict, flush, reverse: bool,
               key_of=lambda name: "anchor_walk_kernel") -> None:
    """One round: each launcher of gos timed warm (100 launches back to
    back) and cold (50, each after a 1 GiB fill), in turn or in reverse
    turn -> appended to res[name]["warm_ms"] and ["cold_ms"]."""
    for name in (list(gos)[::-1] if reverse else list(gos)):
        go, key = gos[name], key_of(name)
        res[name]["warm_ms"].append(kernel_ms(lambda: [go() for _ in range(100)], key))

        def cold():
            for _ in range(50):
                flush.fill_(1)
                go()
        res[name]["cold_ms"].append(kernel_ms(cold, key))


def checked(go, outs, got_of, want) -> dict:
    """One launch on outputs filled with 0xFF bytes, held to the plain
    version's result -> a result record with empty timing lists."""
    import torch

    for t, ff in outs:
        t.fill_(ff)
    go()
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(a.to(torch.int64), b.to(torch.int64)))
                for a, b in zip(got_of(outs), want))
    return dict(equal_plain=equal, warm_ms=[], cold_ms=[])


def main_walk(args, torch) -> int:
    """The packed walk's design items (the default mode)."""
    import chip_smoke as cs
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.ops.device_index import upload_index
    from rapmap_tpu_torch.ops.extend_packed import ext_words
    from rapmap_tpu_torch.ops.mmp import (
        anchor_tables, anchor_walk_plain, dense_phase, pseudo_walk_plain, scan_inputs,
        walk_params,
    )

    out = os.path.join(ROOT, "build", "ablation")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(ROOT, "rapmap_tpu_torch", "csrc", "walk.cu")) as f:
        src = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        sources[name] = os.path.join(out, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(edit(src, edits))
    parent_tables = False
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "rapmap_tpu_torch", "csrc", "walk.cu")
        with open(sources["parent"]) as f:  # the mask interface names the rc mask anch_r
            parent_tables = "anch_r" not in f.read()
    procs = start_builds(sources, out)

    # the smoke chunk of chip_smoke.py: its world, its first 8,192 reads
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    idx, codes, lens, _, _ = cs.build_world(args.seed, 10_000, 262_144, work)
    libs, _ = finish_builds(procs, out)

    dev = torch.device("cuda")
    didx, st = upload_index(idx, dev, lean=True)
    cfg = MapConfig(k=cs.K)
    C = 8192
    w = dense_phase(didx, st, torch.from_numpy(codes[:C]).to(dev),
                    torch.from_numpy(lens[:C].astype(np.int64)).to(dev), cfg)
    prm = walk_params(st, cfg)
    want = anchor_walk_plain(didx, *w, **prm)
    R = w.preads.shape[0]
    H, k = prm["H"], prm["k"]
    outs = walk_outputs(R, H, dev)
    tables = anchor_tables(*w[4:])

    def launcher(name):
        if not (name == "parent" and parent_tables):
            return walk_entry(libs[name], didx, w, prm, outs, paired=True)
        # an older walk.cu: the lane-aligned anchor tables for the masks
        S, L = w.bf.shape[1], w.preads.shape[1]
        args_ = [t.data_ptr() for t in w[:4] + tables] + [
            didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0], didx.sa_cmp.shape[1] - 3,
            didx.text2q.data_ptr(), didx.text2q.shape[0], R, R // 2, L, S, k, H,
            prm["ext_steps"], ext_words(L, k), *(t.data_ptr() for t, _ in outs)]
        types = [VP] * 8 + [I64, I32, VP, I64, I64, I64] + [I32] * 6 + [VP] * 3
        return entry(libs[name], "tqm_anchor_walk", types, args_)

    gos = {n: launcher(n) for n in sources}
    res = {}
    for name, go in gos.items():
        if name == "parent" and parent_tables:  # that interface needs a zeroed buffer
            for t, _ in outs:
                t.zero_()
            go()
            torch.cuda.synchronize()
            res[name] = dict(equal_plain=all(bool(torch.equal(a, b)) for a, b in
                                             zip(hits_of(outs), want)), warm_ms=[], cold_ms=[])
        else:
            res[name] = checked(go, outs, hits_of, want)

    # the charwise and pseudo builds of this walk.cu and the parent's
    fdidx, fst = upload_index(idx, dev)  # the full upload: flat sa and text
    ccfg = MapConfig(k=cs.K, packed_extension=False)
    cw, ckw = scan_inputs(fdidx, fst, torch.from_numpy(codes[:C]).to(dev),
                          torch.from_numpy(lens[:C].astype(np.int64)).to(dev), ccfg)
    cprm = {x: ckw[x] for x in ("k", "H", "ext_steps")}
    other_want = {"charwise": anchor_walk_plain(fdidx, *cw, **cprm, codes=ckw["codes"]),
                  "pseudo": pseudo_walk_plain(*lane_tensors(w), k=k, H=H)}
    others = {}
    for kind in ("charwise", "pseudo"):
        for name in ("as_is", "parent") if args.parent else ("as_is",):
            go = (charwise_entry(libs[name], fdidx, cw, ckw["codes"], cprm, outs)
                  if kind == "charwise" else pseudo_entry(libs[name], w, k, H, outs))
            others[f"{kind}_{name}"] = go
            res[f"{kind}_{name}"] = checked(go, outs, hits_of, other_want[kind])

    flush = torch.empty(1 << 28, dtype=torch.int32, device=dev)
    for rnd in range(args.rounds):  # this walk's forms, then the other builds, each round
        time_round(gos, res, flush, reverse=rnd % 2 == 1)
        time_round(others, res, flush, reverse=rnd % 2 == 1)
    if parent_tables:  # the parent's wrapper zeroed the hit buffer before each launch
        buf = outs[0][0]
        res["parent"]["fill_ms"] = [kernel_ms(lambda: [buf.zero_() for _ in range(100)],
                                              "elementwise") for _ in range(args.rounds)]
    print(json.dumps({"device": cs.nvidia_smi_line(), "lanes": R, "read_len": w.preads.shape[1],
                      "hit_slots": H, "variants": res}), flush=True)
    return 0 if all(v["equal_plain"] for v in res.values()) else 1


def main_k8(args, torch) -> int:
    """The sharded walks (K8) and, beside them, the other builds against the
    parent's walk.cu (--k8)."""
    import chip_smoke as cs
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.ops import mmp
    from rapmap_tpu_torch.ops.device_index import upload_index
    from rapmap_tpu_torch.ops.extend_packed import ext_words, extend_packed
    from rapmap_tpu_torch.parallel import sharded
    from rapmap_tpu_torch.parallel.staged import StagedQuasiMapper

    out = os.path.join(ROOT, "build", "ablation_k8")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(ROOT, "rapmap_tpu_torch", "csrc", "walk.cu")) as f:
        src = f.read()
    sources = {}
    for name, edits in K8_VARIANTS.items():
        sources[name] = os.path.join(out, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(edit(src, edits))
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "rapmap_tpu_torch", "csrc", "walk.cu")
    procs = start_builds(sources, out, verbose=("as_is", "parent"))

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    idx, codes, lens, _, _ = cs.build_world(args.seed, 10_000, 262_144, work)
    dev = torch.device("cuda")
    cfg = MapConfig(k=cs.K)
    didx, st = upload_index(idx, dev, lean=True)
    _, st_c, stack_c, _ = cs.sharded_world(idx, dev)
    _, st_l, stack_l, _ = cs.sharded_world(idx, dev, canonical=False)
    stack_1 = cs.one_shard_stack(didx)
    libs, logs = finish_builds(procs, out)
    registers = {n: walk_registers(logs[n]) for n in ("as_is", "parent") if n in logs}

    B = 262_144 // cs.BATCHES  # a batch of sharded_path; a data row's program is half of it
    C = B // 4

    def batch(n):
        return (torch.from_numpy(np.ascontiguousarray(codes[:n])).to(dev),
                torch.from_numpy(lens[:n].astype(np.int64)).to(dev))

    # K8's input sets: (stack, walk inputs, walk arguments, plain hits)
    sets = {}
    for shape, (r, ln) in (("row", batch(B // 2)), ("chunk", batch(C))):
        for kind, stack, st_ in (("paired", stack_c, st_c), ("lanes", stack_l, st_l)):
            w, kw = sharded.scan_inputs(stack, st_, r, ln, cfg)
            sets[f"{kind}_{shape}"] = (stack, w, kw)
        w, kw = mmp.scan_inputs(didx, st, r, ln, cfg)
        sets[f"one_shard_{shape}"] = (stack_1, w, {x: kw[x] for x in ("k", "H", "ext_steps",
                                                                      "paired")})
    gos, res, outs_of = {}, {}, {}
    for sname, (stack, w, kw) in sets.items():
        want = sharded.sharded_walk_plain(stack, *w, **kw)
        outs_of[sname] = outs = walk_outputs(w.lens2.shape[0], kw["H"], dev)
        for name, lib in libs.items():
            if sname.startswith("one_shard") and name not in ("as_is", "parent"):
                continue
            types, vals = sharded.sharded_walk_args(stack, w, [t for t, _ in outs], **kw)
            go = entry(lib, "tqm_sharded_walk", types, vals)
            gos[f"k8_{sname}_{name}"] = go
            res[f"k8_{sname}_{name}"] = checked(go, outs, hits_of, want)

    # the other builds of this walk.cu and the parent's, on the chunk
    pairs = ("as_is", "parent") if args.parent else ("as_is",)
    _, wp, kwp = sets["one_shard_chunk"]
    prm = {x: kwp[x] for x in ("k", "H", "ext_steps")}
    _, wl, _ = sets["lanes_chunk"]  # explicit lanes in global slots: the whole index's
    outs = outs_of["one_shard_chunk"]
    fdidx, fst = upload_index(idx, dev)  # the full upload: flat sa and text
    cw, ckw = mmp.scan_inputs(fdidx, fst, *batch(C), MapConfig(k=cs.K, packed_extension=False))
    others = {
        "packed_paired": (lambda lib: walk_entry(lib, didx, wp, prm, outs, paired=True),
                          mmp.anchor_walk_plain(didx, *wp, **prm)),
        "packed_lanes": (lambda lib: walk_entry(lib, didx, wl, prm, outs, paired=False),
                         mmp.anchor_walk_lanes_plain(didx, *wl, **prm)),
        "charwise": (lambda lib: charwise_entry(lib, fdidx, cw, ckw["codes"], prm, outs),
                     mmp.anchor_walk_plain(fdidx, *cw, **prm, codes=ckw["codes"])),
        "pseudo": (lambda lib: pseudo_entry(lib, wp, prm["k"], prm["H"], outs),
                   mmp.pseudo_walk_plain(*lane_tensors(wp), k=prm["k"], H=prm["H"])),
    }
    for kind, (make, want) in others.items():
        for name in pairs:
            gos[f"{kind}_{name}"] = go = make(libs[name])
            res[f"{kind}_{name}"] = checked(go, outs, hits_of, want)

    # K9 at the staged path's shape: shard 0 of 8, A_max slots of one batch
    sm = StagedQuasiMapper(idx, cfg, batch=B, read_len=cs.READ_LEN, n_shards=cs.STAGED_SHARDS,
                           device=dev).sm
    sdidx = sm._upload(sm._shard_arrays(0)[0])
    steps = max(1, int(np.ceil(np.log2(min(sm.cfg.max_interval, sm._st.max_interval_idx) + 1)))
                + 1)
    a, _ = cs.staged_anchor_inputs(sm, sdidx, codes[:B], lens[:B], sm.A_max)
    k9_in = [a[f] for f in ("preads", "next_bad", "lens", "b0", "e0", "pos", "active")]
    k9_want = extend_packed(sdidx, *k9_in, cs.K, steps, cs.READ_LEN, lane=a["lane"])
    A = a["lane"].shape[0]
    R9, L9 = a["preads"].shape
    k9_outs = tuple((torch.empty(A, dtype=torch.int64, device=dev), -1) for _ in range(3))
    for name in pairs:
        args_ = [a["preads"].data_ptr(), a["next_bad"].data_ptr(), a["lens"].data_ptr(), None,
                 *(a[f].data_ptr() for f in ("lane", "b0", "e0", "pos", "active")),
                 sdidx.sa_cmp.data_ptr(), sdidx.sa_cmp.shape[0], sdidx.sa_cmp.shape[1] - 3,
                 sdidx.text2q.data_ptr(), sdidx.text2q.shape[0], A, R9, L9, cs.K, steps,
                 ext_words(L9, cs.K), *(t.data_ptr() for t, _ in k9_outs)]
        types = [VP] * 10 + [I64, I32, VP, I64, I64, I64] + [I32] * 4 + [VP] * 3
        gos[f"k9_{name}"] = go = entry(libs[name], "tqm_extend_packed_lanes", types, args_)
        res[f"k9_{name}"] = checked(go, k9_outs, lambda o: [t for t, _ in o], k9_want)

    flush = torch.empty(1 << 28, dtype=torch.int32, device=dev)
    for rnd in range(args.rounds):
        time_round(gos, res, flush, reverse=rnd % 2 == 1,
                   key_of=lambda n: "extend_packed_kernel" if n.startswith("k9_") else
                   "anchor_walk_kernel")
    shapes = {s: dict(lanes=w.lens2.shape[0], shards=len(stack.bases), paired=kw["paired"])
              for s, (stack, w, kw) in sets.items()}
    print(json.dumps({"device": cs.nvidia_smi_line(), "k8_sets": shapes,
                      "shard_slots": [n for _, n in stack_c.bases],
                      "k9_anchors": A, "k9_live": int(a["active"].sum()),
                      "registers": registers, "variants": res}), flush=True)
    return 0 if all(v["equal_plain"] for v in res.values()) else 1


def main_k10(args, torch) -> int:
    """One shard's trip of the split sharded walk (K10) as it stands, at
    128 lanes a block, and the parent's (--k10)."""
    import chip_smoke as cs
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.parallel import sharded

    out = os.path.join(ROOT, "build", "ablation_k10")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(ROOT, "rapmap_tpu_torch", "csrc", "walk.cu")) as f:
        src = f.read()
    sources = {}
    for name, edits in K10_VARIANTS.items():
        sources[name] = os.path.join(out, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(edit(src, edits))
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "rapmap_tpu_torch", "csrc", "walk.cu")
    procs = start_builds(sources, out, verbose=("as_is", "parent"))

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    idx, codes, lens, _, _ = cs.build_world(args.seed, 10_000, 262_144, work)
    dev = torch.device("cuda")
    arr, st, _, _ = cs.sharded_world(idx, dev)
    (sset,) = sharded.upload_sharded(arr, [[dev] * cs.SHARDS], split_idx=True)
    n = 262_144 // cs.BATCHES // 2  # a data row's program of sharded_path
    r = torch.from_numpy(np.ascontiguousarray(codes[:n])).to(dev)
    ln = torch.from_numpy(lens[:n].astype(np.int64)).to(dev)
    w, kw = sharded.scan_inputs(sset, st, r, ln, MapConfig(k=cs.K))
    saved = []  # (trip, shard, index, base, count, lane inputs), the plain loop's

    def recorder(didx, base, n_local, *lanes, k, ext_steps, out=None):
        trip, p = divmod(len(saved), cs.SHARDS)
        saved.append((trip, p, didx, base, n_local, lanes[:4] + tuple(t.clone()
                                                                     for t in lanes[4:])))
        return sharded.sharded_trip_plain(didx, base, n_local, *lanes, k=k,
                                          ext_steps=ext_steps, out=out)

    sharded.trip_loop(sset, w, recorder, sharded.sharded_advance_plain, **kw)
    active = [int(x[5][7].sum()) for x in saved[::cs.SHARDS]]
    trips = {"first": 0, "trip1": 1, "empty": active.index(0)}
    libs, logs = finish_builds(procs, out)
    registers = {n: walk_registers(logs[n], "sharded_trip_kernel")
                 for n in ("as_is", "parent") if n in logs}

    k, steps = kw["k"], kw["ext_steps"]
    shard_gos, res, sets = {}, {}, {}  # (trip, build): the 4 shards' launchers
    for tname, trip in trips.items():
        for t_, p, didx, base, n_local, lanes in saved:
            if t_ != trip:
                continue
            want = sharded.sharded_trip_plain(didx, base, n_local, *lanes, k=k, ext_steps=steps)
            outs = tuple((torch.empty(lanes[2].shape, dtype=torch.int64, device=dev), -1)
                         for _ in range(3))
            act, b0 = lanes[7], lanes[4]
            sets[f"{tname}_s{p}"] = dict(trip=trip, shard=p, active=int(act.sum()), owned=int(
                (act & (b0 - base >= 0) & (b0 - base < n_local)).sum()))
            types, vals = sharded.sharded_trip_args(didx, base, n_local, lanes,
                                                    [t for t, _ in outs], k=k, ext_steps=steps)
            for name, lib in libs.items():
                go = entry(lib, "tqm_sharded_trip", types, vals)
                shard_gos.setdefault(f"{tname}_{name}", []).append(go)
                res[f"{tname}_s{p}_{name}"] = checked(go, outs, lambda o: [t for t, _ in o],
                                                      want)

    # each (trip, build) timed over its 4 shards' launches, the mean a launch:
    # warm 100 rounds of the 4 back to back, cold 50 with a 1 GiB fill before
    # each launch; the pairs in turn, then in reverse turn
    flush = torch.empty(1 << 28, dtype=torch.int32, device=dev)
    means = {key: dict(warm_ms=[], cold_ms=[]) for key in shard_gos}
    for rnd in range(args.rounds):
        for key in list(shard_gos)[::-1] if rnd % 2 else list(shard_gos):
            gos_ = shard_gos[key]

            def warm():
                for _ in range(100):
                    for go in gos_:
                        go()

            def cold():
                for _ in range(50):
                    for go in gos_:
                        flush.fill_(1)
                        go()

            means[key]["warm_ms"].append(kernel_ms(warm, "sharded_trip_kernel"))
            means[key]["cold_ms"].append(kernel_ms(cold, "sharded_trip_kernel"))
    print(json.dumps({"device": cs.nvidia_smi_line(), "lanes": int(w.lens2.shape[0]),
                      "trips": trips, "active_lanes_by_trip": active, "sets": sets,
                      "registers": registers, "mean_a_launch_over_shards": means,
                      "checks": res}), flush=True)
    return 0 if all(v["equal_plain"] for v in res.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose csrc/walk.cu to time beside this one")
    ap.add_argument("--k8", action="store_true", help="time the sharded walks (K8) and, with "
                    "--parent, every other build against the parent's")
    ap.add_argument("--k10", action="store_true", help="time the split walk's sharded trip "
                    "(K10) and, with --parent, the parent's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("walk_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.k10:
        return main_k10(args, torch)
    return main_k8(args, torch) if args.k8 else main_walk(args, torch)


if __name__ == "__main__":
    sys.exit(main())
