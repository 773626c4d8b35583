"""Rounding to a lower precision, for the controls.

Each value is rounded to nearest, ties to even, to bfloat16's 8 or TF32's
11 significant bits and kept in float32, so that the products and sums that
follow run in fp32, as a bf16 or TF32 matrix unit accumulates.  Imports
nothing of the program.
"""

from __future__ import annotations

import torch

LOWER = ("bf16", "tf32")


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as float32 values that ``precision`` holds exactly."""
    x = x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    # TF32 keeps 10 of float32's 23 mantissa bits: round the 13 it drops.
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)
