"""Micro-benchmark: scatter-add strategies for the atlas fuse and the
surfel moments at the pipeline's production shapes (counterpart of the
JAX package's tools/microbench_scatter.py, with its seven strategies on
its inputs: the same default_rng(0) draws).

The map update is scatter-dominated: the fuse adds 9 channel groups (29
channels) of NU = (1024 surfels + 512 features) x K_ASSOC 8 = 12,288
updates with one shared duplicate-index set into the 128 x 2048-row atlas,
and the surfel extraction one 15-channel scatter of 8,192 points into its
8,193-cell grid. The JAX tool's strategies, with `index_add` (one atomic
add per element on CUDA) as the scatter-add:
  nine narrow scatters / one packed 29-wide scatter into T*M, one packed
  scatter into the 7 x 1024 pool space, a blocked one-hot matmul into the
  pool, a sorted packed scatter, the surfel-moment scatter and its one-hot
  matmul;
and the port's production route, ops/binned.scatter_accumulate
(`index_put(accumulate=True)` on CUDA: a stable sort of the indices and an
in-order sum of each run, no float atomics, so the result is
bit-reproducible), at the fuse and the surfel shapes.

On the card each strategy is timed by CUDA events over --reps calls after
one warm-up call; on the CPU by the host clock. Prints one JSON line per
strategy, {name, ms, checksum}, the checksum being the float64 sum of the
first output (as the JAX tool's), then {"device": ...}.

Usage: python -m gcslam_torch.tools.microbench_scatter [--cpu] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import time

# the production shapes: NU fuse updates into T*M atlas rows (or the P-row
# pool), D channels; NS surfel-moment updates into CS cells, DS channels
SHAPES = dict(NU=12288, TM=128 * 2048, P=7 * 1024, D=29, NS=8192, CS=8193, DS=15, NS_CELLS=1500)
FUSE_WIDTHS = [9, 3, 9, 1, 1, 1, 3, 1, 1]
BLOCK = 2048


def inputs(device, NU, TM, P, D, NS, CS, DS, NS_CELLS):
    """The JAX tool's draws, in its order: fuse targets concentrated on 2048
    live rows of T*M, pool targets, the payload, then the surfel ones."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    idx_tm = rng.choice(rng.choice(TM, size=2048, replace=False), size=NU).astype(np.int32)
    idx_p = rng.integers(0, P, size=NU).astype(np.int32)
    payload = rng.standard_normal((NU, D)).astype(np.float32)
    idx_s = rng.integers(0, NS_CELLS, size=NS).astype(np.int32)
    pay_s = rng.standard_normal((NS, DS)).astype(np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in
            dict(idx_tm=idx_tm, idx_p=idx_p, payload=payload, idx_s=idx_s, pay_s=pay_s).items()}


def strategies(TM, P, D, CS, DS, **_):
    """name -> (function, names of its inputs). Each returns its output;
    the first, nine_narrow_scatters_TM, the sum of its nine outputs' sums
    (the JAX tool's)."""
    import torch

    from gcslam_torch.ops import binned

    def zeros(n, w, like):
        return torch.zeros((n, w), dtype=like.dtype, device=like.device)

    def nine_scatters(idx, pay):
        idx, total, o = idx.long(), 0.0, 0
        for w in FUSE_WIDTHS:
            total = total + zeros(TM, w, pay).index_add(0, idx, pay[:, o:o + w]).sum()
            o += w
        return total

    def one_scatter(n):
        return lambda idx, pay: zeros(n, pay.shape[1], pay).index_add(0, idx.long(), pay)

    def binned_matmul(n):
        def fn(idx, pay):
            acc = zeros(n, pay.shape[1], pay)
            rows = torch.arange(n, dtype=idx.dtype, device=idx.device)
            for s in range(0, idx.shape[0], BLOCK):
                acc = acc + (idx[s:s + BLOCK][None, :] == rows[:, None]).to(pay.dtype) @ pay[s:s + BLOCK]
            return acc
        return fn

    def sorted_scatter(idx, pay):
        order = torch.argsort(idx)
        return zeros(TM, pay.shape[1], pay).index_add(0, idx[order].long(), pay[order])

    return {
        "nine_narrow_scatters_TM": (nine_scatters, ("idx_tm", "payload")),
        "one_packed_scatter_TM": (one_scatter(TM), ("idx_tm", "payload")),
        "one_packed_scatter_pool": (one_scatter(P), ("idx_p", "payload")),
        "binned_matmul_pool": (binned_matmul(P), ("idx_p", "payload")),
        "sorted_packed_scatter_TM": (sorted_scatter, ("idx_tm", "payload")),
        "surfel_moment_scatter": (one_scatter(CS), ("idx_s", "pay_s")),
        "surfel_moment_matmul": (binned_matmul(CS), ("idx_s", "pay_s")),
        "binned_scatter_accumulate_TM": (lambda idx, pay: binned.scatter_accumulate(idx, pay, TM),
                                         ("idx_tm", "payload")),
        "binned_scatter_accumulate_surfel": (lambda idx, pay: binned.scatter_accumulate(idx, pay, CS),
                                             ("idx_s", "pay_s")),
    }


def run(device, reps: int = 20, shapes=None) -> list:
    """[{name, ms, checksum, out}] for every strategy at `shapes` (default
    SHAPES); `out` is the strategy's output tensor."""
    import torch

    shapes = dict(SHAPES, **(shapes or {}))
    xs = inputs(device, **shapes)
    results = []
    for name, (fn, keys) in strategies(**shapes).items():
        args = [xs[k] for k in keys]
        out = fn(*args)
        checksum = float(out.double().sum())
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            ms = 1e3 * (time.perf_counter() - t0) / reps
        results.append({"name": name, "ms": ms, "checksum": checksum, "out": out})
    return results


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    results = run(device, args.reps)
    for r in results:
        print(json.dumps({"name": r["name"], "ms": round(r["ms"], 4), "checksum": round(r["checksum"], 3)}))
    print(json.dumps({"device": device.type,
                      "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}))
    return results


if __name__ == "__main__":
    main()
