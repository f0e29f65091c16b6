"""Bitonic sort of the collate voting sort's packed 2-word keys.

Port of rapmap_tpu.ops.pallas.sort2. `bitonic_sort_pairs` sorts N pairs
(hi, lo) of 32-bit words ascending by the unsigned 64-bit value hi·2^32 + lo,
N a power of two. The words ride int32 tensors holding the uint32 bit
patterns. On a CUDA tensor it runs the hand-written kernel of
csrc/sort2.cu (the counterpart of the Pallas kernel
`bitonic_sort_pairs_pallas`; one launch of one thread-block cluster for
8,192 <= N <= 65,536, which covers the main path); on a CPU tensor it runs
`bitonic_sort_pairs_plain`, the same network in PyTorch. There is no payload,
so the unstable network's output equals a stable sort's.
"""

from __future__ import annotations

import ctypes

import torch

from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.ops.bits import as_i32, u32


def bitonic_sort_pairs_plain(hi: torch.Tensor, lo: torch.Tensor):
    """The bitonic network in PyTorch: log2(N)·(log2(N)+1)/2 compare-exchange
    steps, comparisons on int64 copies masked to 32 bits. int32 bit
    patterns in, int32 bit patterns out."""
    N = hi.shape[0]
    if N < 2 or N & (N - 1):
        raise ValueError("bitonic sort needs a power-of-two length >= 2")
    h, l = u32(hi), u32(lo)
    logn = N.bit_length() - 1
    for kk in range(1, logn + 1):
        k = 1 << kk
        j = k >> 1
        while j >= 1:
            # partner(i) = i ^ j via reshape (N/2j, 2, j); direction from the
            # k-block parity of the low element's index
            m = N // (2 * j)
            h3 = h.reshape(m, 2, j)
            l3 = l.reshape(m, 2, j)
            base = torch.arange(m, device=h.device) * (2 * j)
            asc = ((base & k) == 0)[:, None]
            ha, hb, la, lb = h3[:, 0], h3[:, 1], l3[:, 0], l3[:, 1]
            a_le = (ha < hb) | ((ha == hb) & (la <= lb))
            keep = a_le == asc  # the low slot keeps a
            h = torch.stack(
                [torch.where(keep, ha, hb), torch.where(keep, hb, ha)], dim=1
            ).reshape(N)
            l = torch.stack(
                [torch.where(keep, la, lb), torch.where(keep, lb, la)], dim=1
            ).reshape(N)
            j >>= 1
    return as_i32(h), as_i32(l)


SORT_PATHS = ("one block", "one cluster launch", "tiled passes")


def sort_path(n: int) -> str:
    """Which path of csrc/sort2.cu sorts n pairs (asks the built library)."""
    fn = kernels.library("sort2").tqm_bitonic_sort_path
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64]
    return SORT_PATHS[fn(n)]


def bitonic_sort_pairs(hi: torch.Tensor, lo: torch.Tensor):
    """Sorted copies of (hi, lo): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if hi.device.type == "cpu" and lo.device.type == "cpu":
        return bitonic_sort_pairs_plain(hi, lo)
    if hi.device.type != "cuda" or lo.device != hi.device:
        raise ValueError("bitonic_sort_pairs: hi and lo must lie on one CUDA device")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError("bitonic_sort_pairs takes int32 tensors (uint32 bit patterns)")
    if hi.dim() != 1 or hi.shape != lo.shape:
        raise ValueError("bitonic_sort_pairs takes two 1-D tensors of equal length")
    N = hi.shape[0]
    if N < 2 or N & (N - 1):
        raise ValueError("bitonic sort needs a power-of-two length >= 2")
    hi, lo = hi.contiguous(), lo.contiguous()
    out_hi, out_lo = torch.empty_like(hi), torch.empty_like(lo)
    fn = kernels.library("sort2").tqm_bitonic_sort_pairs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream(hi.device).cuda_stream
        rc = fn(hi.data_ptr(), lo.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(), N, stream)
    if rc != 0:
        raise RuntimeError(f"tqm_bitonic_sort_pairs launch failed: CUDA error {rc}")
    kernels.LAUNCHES["bitonic_sort_pairs"] += 1
    return out_hi, out_lo
