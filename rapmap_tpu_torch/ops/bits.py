"""uint32 words carried in int64 tensors.

The reference computes on uint32 arrays; torch's uint32 lacks shifts,
compares and adds on the CPU. The port carries every such word as an int64
tensor holding a value in [0, 2^32): compares and shifts are then exact,
and each left shift is masked back to 32 bits (`M32`), which is what the
reference's uint32 arithmetic does implicitly. Device tables keep the
reference's int32 bit patterns; `u32` widens them on gather, `as_i32`
narrows results back for the int32 wire.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 value in [0, 2^32)."""
    return x.to(torch.int64) & M32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def shl32(x: torch.Tensor, s) -> torch.Tensor:
    """uint32 left shift (bits shifted past bit 31 drop)."""
    return (x << s) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c for x in [0, 2^32) and a constant c < 2^32,
    multiplied in 16-bit halves of c so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of x in [0, 2^32) as a 32-bit word (32 for x == 0).
    frexp of the float64 copy is exact here: every such x is representable,
    and its exponent is the bit length."""
    _, e = torch.frexp(x.to(torch.float64))
    return 32 - e.to(torch.int64)
