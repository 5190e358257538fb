"""Weight layouts the port's kernels read, applied once when parameters are
packed.

:func:`fragment_order` is the order ``mma.sync`` kernels stream a weight in
(registers of ``mma.m16n8k16`` B fragments); :func:`swizzled_tiles` is the
order ``wgmma`` kernels pull a weight in (64 x 64 tiles, K-major, in the
128-byte-swizzled shared-memory layout, each tile contiguous so that one
bulk copy brings it in).
"""

from __future__ import annotations

import torch

TILE = 64                 # rows and columns of a wgmma weight tile


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """A padded ``[K, N]`` weight (K, N multiples of 16) in the order an
    ``mma.sync`` kernel streams it: ``[N/16, K/16, 32 lanes, 8]``, flattened.

    For 16-column block ``nb`` and k-step ``ks``, lane ``g * 4 + c`` holds
    the B fragments of ``mma.m16n8k16`` for the block's two n8 tiles ``j``:
    register ``2 j + h`` packs ``W[16 ks + 8 h + 2 c + e, 16 nb + 8 j + g]``
    for e = 0, 1 (PTX ISA, "Matrix fragments for mma.m16n8k16").
    """
    k, n = w.shape
    return (w.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)   # ks h c e nb j g
            .permute(4, 0, 6, 2, 5, 1, 3)                # nb ks g c j h e
            .reshape(-1))


def swizzled_offset(row: int, k: int) -> int:
    """Element offset of ``(row, k)`` in one 128-byte-swizzled tile of 64
    bf16 columns: rows of 64 elements, the 8-element chunk ``k // 8`` of a
    row stored at chunk ``(k // 8) ^ (row % 8)``."""
    return row * TILE + (((k >> 3) ^ (row & 7)) << 3) + (k & 7)


def swizzled_tiles(w: torch.Tensor) -> torch.Tensor:
    """A padded ``[K, N]`` weight (K, N multiples of 64) as the tiles a
    ``wgmma`` kernel pulls: ``[N/64, K/64, 64, 64]``, flattened.

    Tile ``(nb, kc)`` holds ``W[64 kc + k, 64 nb + m]`` at
    ``swizzled_offset(m, k)``: the transposed weight, K-major, which is the
    64-row operand of ``out^T = W^T h^T``.
    """
    k, n = w.shape
    t = (w.t().reshape(n // TILE, TILE, k // TILE, 8, 8)   # nb m kc chunk e
         .permute(0, 2, 1, 3, 4))                          # nb kc m chunk e
    m = torch.arange(TILE, device=w.device)[:, None]
    chunk = torch.arange(8, device=w.device)[None, :]
    # the chunk stored at position c of row m is chunk c ^ (m % 8)
    return t[:, :, m, chunk ^ (m & 7), :].reshape(-1)
