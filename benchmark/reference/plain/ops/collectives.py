"""The sharded step's collectives, left out: the reference runs one
process on one device, where the step takes no ShardContext."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class AxisShard(NamedTuple):
    """This rank's place on one mesh axis."""

    axis: str
    group: str  # the name of this rank's process group along the axis
    index: int
    size: int

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's contiguous block of n items."""
        if n % self.size:
            raise ValueError(f"mesh axis {self.axis!r} of size {self.size} must divide {n}")
        step = n // self.size
        return self.index * step, (self.index + 1) * step


class ShardContext(NamedTuple):
    """What scan_step needs of the mesh: the "hyp" and "map" axes (None
    where the mesh has no such axis)."""

    hyp: Optional[AxisShard]
    map: Optional[AxisShard]


def _unsharded(*_args, **_kwargs):
    raise NotImplementedError("the reference runs the unsharded step only")


all_gather = gather_blocks = gather_rows = write_rows = sum_over = _unsharded
