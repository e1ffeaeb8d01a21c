"""MA-Hex 3D tile addressing (counterpart of the JAX package's ops/tiling.py): hex
axes a1=(1,0), a2=(1/2, sqrt(3)/2) in XY, linear Z; cell = floor(s/h);
packed int64 tile id with 21 bits per axis and a fixed bias."""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.plain import constants as C

BITS_PER_AXIS = 21
BIAS = 1 << 20
MASK = (1 << BITS_PER_AXIS) - 1
SQRT3_2 = float(np.sqrt(3.0) / 2.0)


def hex_cells_from_xyz(xyz: torch.Tensor, h_tile: float):
    """(..., 3) -> (c1, c2, cz) int64 MA-Hex 3D cell coords."""
    h = max(float(h_tile), 1e-12)
    s1 = xyz[..., 0]
    s2 = xyz[..., 0] * 0.5 + xyz[..., 1] * SQRT3_2
    c1 = torch.floor(s1 / h).to(torch.int64)
    c2 = torch.floor(s2 / h).to(torch.int64)
    cz = torch.floor(xyz[..., 2] / h).to(torch.int64)
    return c1, c2, cz


def tile_ids_from_cells(c1: torch.Tensor, c2: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    u1 = (c1 + BIAS) & MASK
    u2 = (c2 + BIAS) & MASK
    uz = (cz + BIAS) & MASK
    return (u1 << (2 * BITS_PER_AXIS)) | (u2 << BITS_PER_AXIS) | uz


def tile_ids_from_xyz(xyz: torch.Tensor, h_tile: float = C.H_TILE) -> torch.Tensor:
    return tile_ids_from_cells(*hex_cells_from_xyz(xyz, h_tile))


def hex_disk_axial(radius: int) -> List[Tuple[int, int]]:
    r = int(radius)
    out = []
    for q in range(-r, r + 1):
        for rr in range(max(-r, -q - r), min(r, -q + r) + 1):
            out.append((q, rr))
    out.sort()
    return out


def stencil_offsets(radius_xy: int, radius_z: int) -> np.ndarray:
    """(S, 3) int64 offsets: z-slab outer, sorted hex disk inner."""
    rows = [(dq, dr, dz) for dz in range(-int(radius_z), int(radius_z) + 1)
            for dq, dr in hex_disk_axial(radius_xy)]
    return np.asarray(rows, dtype=np.int64)


@lru_cache(maxsize=None)
def _stencil_offsets_on(radius_xy: int, radius_z: int, device: torch.device) -> torch.Tensor:
    """stencil_offsets on `device`, made once per (radii, device): a copy
    from the host each step would synchronize with the card. Read only."""
    return torch.as_tensor(stencil_offsets(radius_xy, radius_z), device=device)


def stencil_tile_ids(center_xyz: torch.Tensor, radius_xy: int, radius_z: int,
                     h_tile: float = C.H_TILE) -> torch.Tensor:
    """(S,) int64 tile ids of the stencil around center_xyz."""
    c1, c2, cz = hex_cells_from_xyz(center_xyz, h_tile)
    offs = _stencil_offsets_on(int(radius_xy), int(radius_z), center_xyz.device)
    return tile_ids_from_cells(c1 + offs[:, 0], c2 + offs[:, 1], cz + offs[:, 2])
