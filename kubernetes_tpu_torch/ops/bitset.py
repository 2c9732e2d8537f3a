"""Bitset primitives used by every mask function.

PyTorch counterpart of kubernetes_tpu/ops/bitset.py. The encoder packs
bitsets as uint32 words; on the device they are widened to int64 (torch
lacks shifts on uint32 CUDA tensors), so every word is in [0, 2**32)
and a shift right is a logical shift.
"""

from __future__ import annotations

import torch


def test_bit(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mask[..., W] words, idx[...] -> bool: bit `idx` set? Negative idx
    (unknown vocab id) tests as False. mask and idx broadcast as in
    jnp.take_along_axis."""
    safe = idx.clamp(min=0)
    shape = torch.broadcast_shapes(mask.shape[:-1], idx.shape)
    words = torch.gather(
        mask.expand(*shape, mask.shape[-1]), -1,
        torch.div(safe, 32, rounding_mode="floor").expand(shape)[..., None],
    )[..., 0]
    bit = (words >> (safe % 32)) & 1
    return (bit != 0) & (idx >= 0)


def intersects(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """any common bit along the last (word) axis."""
    return ((a & b) != 0).any(dim=-1)


def popcount(mask: torch.Tensor) -> torch.Tensor:
    """number of set bits of 32-bit words, summed over the word axis ->
    int64. The final `& 0xFF` stands in for the uint32 wrap of the
    reference's byte-sum multiply."""
    x = mask & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(dim=-1)
