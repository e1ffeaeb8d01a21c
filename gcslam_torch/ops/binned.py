"""Duplicate-index accumulation and drop-mode scatters (counterpart of
the JAX package's ops/binned.py).

`acc[idx[i]] += payload[i]` with duplicate indices is the core of the
surfel moments and the atlas fuse. Each bin must sum its rows in row order,
with no float atomics, so a run is bit-reproducible (and the CPU result
equals the JAX package's serial scatter-add): on the CPU `index_add` is a
serial pass; on CUDA `index_put(accumulate=True)` stable-sorts the
indices and sums each run of duplicates in order (`index_add` there would
use atomics, and `index_put` on the CPU is threaded). Both are the
out-of-place forms, so that the scatters run under torch.func.vmap (the
replay sweep's run axis) into targets allocated without it.

JAX's `mode="drop"` drops positive out-of-range targets but wraps negative
ones; torch indexing raises (CPU) or asserts (CUDA) on either. Every
scatter here therefore routes out-of-range rows to an explicit sentinel row
past the end, which is sliced off.
"""

from __future__ import annotations

import torch


def _route(idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n_bins), idx, n_bins)


def scatter_accumulate(idx: torch.Tensor, payload: torch.Tensor, n_bins: int) -> torch.Tensor:
    """acc (n_bins, ...) with acc[b] = sum of payload rows where idx == b;
    rows whose index is outside [0, n_bins) drop."""
    acc = payload.new_zeros((n_bins + 1,) + payload.shape[1:])
    routed = _route(idx, n_bins)
    if acc.is_cuda:
        acc = acc.index_put((routed,), payload, accumulate=True)
    else:
        acc = acc.index_add(0, routed, payload)
    return acc[:n_bins]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*lead, M, ...) gathered along the dim after the leading ones at
    idx (*lead, k) -> (*lead, k, ...); e.g. x (A, M, ...), idx (A, k)."""
    d = idx.dim() - 1
    full_idx = idx.reshape(idx.shape + (1,) * (x.dim() - d - 1)).expand(idx.shape + x.shape[d + 1:])
    return torch.gather(x, d, full_idx)


def scatter_set(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Copy of `target` with rows idx[i] set to values[i]; out-of-range rows
    drop. In-range indices must be unique (as in every caller)."""
    n = target.shape[0]
    out = torch.cat([target, target[:1]], dim=0)
    return out.index_put((_route(idx, n),), values.to(target.dtype))[:n]
