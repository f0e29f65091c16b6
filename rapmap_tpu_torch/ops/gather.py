"""Gather helpers with the reference's clamped semantics (rapmap_tpu.ops.gather:
`jnp.take(..., mode="clip")`): out-of-range indices read the nearest end
instead of faulting."""

from __future__ import annotations

import torch


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (B, N), idx (B, M) int -> (B, M): tab[b, idx[b, m]] (clamped)."""
    return torch.gather(tab, 1, idx.clamp(0, tab.shape[1] - 1))


def flat_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (N,), idx any-shape int -> tab[idx] (clamped)."""
    return tab[idx.clamp(0, tab.shape[0] - 1)]


def row_gather_nd(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (N, C), idx any-shape int -> (*idx.shape, C) (clamped)."""
    return tab[idx.clamp(0, tab.shape[0] - 1)]
