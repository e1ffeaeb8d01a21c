"""The collectives of a sharded step: what the JAX package's GSPMD
partitioner inserts, written out over torch.distributed.

A rank knows its place on a mesh axis as an `AxisShard` (parallel/mesh.py
builds them) and the step takes a `ShardContext` of its "hyp" and "map"
axes. The collective is one custom operator, `gcslam::all_gather`, with a
vmap rule: under the sweep's torch.func.vmap the run axis is a batch dim
that a plain `dist.all_gather` cannot see, so the rule moves every vmapped
dim to the front and the operator gathers the physical tensors. It packs
all its tensors, of any dtype, into one byte buffer: one collective per
call. A read of sharded rows gathers every rank's rows and then selects
each row from its owner, never masks and all-reduces, so every value
arrives bit-exact (no -0.0 from a sum of zeros, no integer or bool
all-reduce, which gloo lacks). COUNTER counts the collectives by axis.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gcslam_torch.ops.binned import scatter_set

# collectives since the last COUNTER.clear(), by mesh axis
COUNTER: Dict[str, int] = {}
# process groups by name: the custom operator takes the group's name, a string
_GROUPS: Dict[str, dist.ProcessGroup] = {}


def register_group(pg: dist.ProcessGroup) -> str:
    """Make `pg` known to the collective by its name; returns the name."""
    _GROUPS[pg.group_name] = pg
    return pg.group_name


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


@torch.library.custom_op("gcslam::all_gather", mutates_args=())
def _all_gather_op(xs: List[torch.Tensor], group: str, axis: str) -> List[torch.Tensor]:
    pg = _GROUPS[group]
    n = dist.get_world_size(pg)
    # (a one-element tensor may keep a stride other than 1 through reshape)
    flats = [x.reshape(-1).clone(memory_format=torch.contiguous_format).view(torch.uint8) for x in xs]
    buf = torch.cat(flats)
    out = buf.new_empty((n, buf.numel()))
    dist.all_gather(list(out.unbind(0)), buf, group=pg)
    COUNTER[axis] = COUNTER.get(axis, 0) + 1
    res, o = [], 0
    for x, f in zip(xs, flats):
        part = out[:, o:o + f.numel()].clone(memory_format=torch.contiguous_format)
        res.append(part.reshape(-1).view(x.dtype).reshape((n,) + x.shape))
        o += f.numel()
    return res


@_all_gather_op.register_vmap
def _all_gather_vmap(info, in_dims, xs, group, axis):
    """Gather the physical tensors, vmapped dim first; the rank dim is then
    dim 0 and the vmapped dim dim 1."""
    dims = in_dims[0]
    out = _all_gather_op([x if d is None else x.movedim(d, 0) for x, d in zip(xs, dims)], group, axis)
    return out, [None if d is None else 1 for d in dims]


def all_gather(xs: Sequence[torch.Tensor], shard: AxisShard) -> List[torch.Tensor]:
    """Every rank's xs along the axis of `shard`: each result has a leading
    dim of the axis size, in rank order. One collective for all of xs."""
    return _all_gather_op(list(xs), shard.group, shard.axis)


def gather_blocks(xs: Sequence[torch.Tensor], shard: AxisShard, dim: int = 0) -> List[torch.Tensor]:
    """The whole of tensors split in contiguous blocks along `dim` over
    `shard` (each x is this rank's block). One collective for all of xs."""
    return [torch.cat(list(g.unbind(0)), dim=dim) for g in all_gather(xs, shard)]


def gather_rows(xs: Sequence[torch.Tensor], idx: torch.Tensor, shard: AxisShard) -> List[torch.Tensor]:
    """x_global[idx] for each x, where x is this rank's contiguous block of
    dim 0 of x_global: every rank reads the rows it owns (clamped rows
    elsewhere), and each row is taken from its owner's part."""
    n_local = xs[0].shape[0]
    local = torch.clamp(idx - shard.index * n_local, 0, n_local - 1)
    parts = all_gather([x[local] for x in xs], shard)
    owner = torch.div(idx, n_local, rounding_mode="floor")
    pos = torch.arange(idx.shape[0], device=idx.device)
    return [p[owner, pos] for p in parts]


def write_rows(x: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    """Copy of this rank's block x of dim 0 of x_global, with the rows of
    x_global[idx] = values that it owns written; the others drop to the
    sentinel row (ops/binned.scatter_set). Indices must be unique."""
    return scatter_set(x, idx - shard.index * x.shape[0], values)


def sum_over(x: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    """Sum of every rank's x along the axis, in rank order."""
    return all_gather([x], shard)[0].sum(0)
