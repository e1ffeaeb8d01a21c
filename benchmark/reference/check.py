"""The comparison that decides `correct`: the program's outputs against the
plain reference (reference/plain, a frozen copy of the port's step,
frontend and loop detector with the CUDA kernels replaced by their plain
PyTorch versions), on the inputs the benchmark made from the seed.

The reference follows the program step by step from the program's own
state: over a segment of scans it starts from the state the program held
before the segment's first scan (or from its own init_state at scan 0) and
runs the plain step on its own inputs, with the loop factors its own loop
detector gives for the calls the program's detector received. A SLAM
filter's trajectory is chaotic in the last bits (a one-ulp change of a
float32 point moves a 50-scan trajectory by millimetres), so a reference
that ran a whole pass alone would measure that chaos, not the program;
and the first scans from init_state, where the map holds a handful of
primitives, are a knife edge (a last-bit difference flips which points
the map takes in, by millimetres of pose, on a few seeds in twelve): the
segment from init_state is the first scan alone, the later first scans
are segments of one scan each from the program's state where a driver
has it, and the longer segments start from a state ten scans or more
into the run.
What it compares:

  - init_mismatch: elements of the program's init_state that differ from
    the reference's (exact);
  - pose_gap_m, rot_gap_rad: the largest translation and rotation gap of a
    scan's pose over the segments;
  - tape_gap_median: the median over the segments of a segment's largest
    ScanTape gap, a field's gap taken as a share of that field's largest
    magnitude in the reference over every compared scan; a field whose
    largest magnitude there is under TAPE_FLOOR is rounding alone (the PSD
    projection's delta of a matrix that is PSD already, an anchor drift of
    ~1e-13) and is left out, by that rule on the reference's values;
  - state_gap_median: the median over the segments of the largest gap of a
    leaf of the state after a segment's last scan, as a share of the
    leaf's largest magnitude (beliefs, hypothesis weights, noise states
    and the atlas).
    Both are medians, not the widest gap: a near-tie in one of the
    filter's discrete choices (which points the map takes in) can resolve
    the other way under a last-bit difference between a kernel and its
    plain version, and then moves that segment's tape and state by as
    much as a fault would (a gap of 1.0), while the poses move by ~1e-6 m;
    a fault or a lower precision moves every segment. The widest tape and
    state gaps, and each segment's gaps, are printed on standard error;
  - loop_mismatch: loop-detector results that differ (exact);
  - resume_mismatch: where the states came from a second replay of the
    compared bag after the window (run_bag keeps no hook), the elements of
    its poses, tapes and final state that differ from the timed replay's
    (exact: the states are those the timed replay held);
  - decode_gap: the largest gap of a field of the decoded scan batches
    against the reference's decode of the same bag file, as a share of the
    field's largest magnitude (the host's decode is exact; the camera
    rows' lift on the card runs the eigen kernels, the reference their
    plain versions).

It imports nothing of the program: the program's outputs arrive as numpy
trees (state_tree) and arrays."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.plain.frontend.loop import LoopConfig, LoopDetector
from benchmark.reference.plain.models import config as rconfig
from benchmark.reference.plain.models import scan_step as rstep
from benchmark.reference.plain.ops import se3

TAPE_FLOOR = 1e-6


def state_tree(state):
    """A tree of named tuples of tensors as nested dicts of numpy arrays."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if hasattr(state, "_fields"):
        return {f: state_tree(getattr(state, f)) for f in state._fields}
    raise TypeError(f"unexpected leaf {type(state)}")


def leaves(tree, prefix: str = ""):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def mismatches(a, b) -> int:
    """Elements that differ between two trees (NaN equals NaN; a missing or
    reshaped leaf counts whole)."""
    la, lb = dict(leaves(a)), dict(leaves(b))
    n = 0
    for k in la.keys() | lb.keys():
        if k not in la or k not in lb or la[k].shape != lb[k].shape:
            n += max(la.get(k, np.zeros(1)).size, lb.get(k, np.zeros(1)).size)
            continue
        x, y = la[k], lb[k]
        same = (x == y) | ((x != x) & (y != y)) if x.dtype.kind == "f" else (x == y)
        n += int(x.size - np.count_nonzero(same))
    return n


def rel_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """max |prog - ref| over max |ref| (a NaN or inf on either side where
    the other is finite gives inf)."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if p.shape != r.shape:
        return float("inf")
    if p.size == 0:
        return 0.0
    if not np.array_equal(np.isfinite(p), np.isfinite(r)):
        return float("inf")
    fin = np.isfinite(r)
    if not fin.any():
        return 0.0
    scale = float(np.abs(r[fin]).max())
    d = float(np.abs(p[fin] - r[fin]).max())
    if d == 0.0:
        return 0.0
    return d / scale if scale > 0.0 else float("inf")


def pose_gaps(prog: np.ndarray, ref: np.ndarray):
    """(largest translation gap, largest rotation angle gap) of (n, 6) poses
    [t, rotvec]."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if not (np.isfinite(p).all() and np.isfinite(r).all()):
        return float("inf"), float("inf")
    dt = float(np.linalg.norm(p[:, :3] - r[:, :3], axis=1).max())
    Rp = se3.so3_exp(torch.as_tensor(p[:, 3:], dtype=torch.float64))
    Rr = se3.so3_exp(torch.as_tensor(r[:, 3:], dtype=torch.float64))
    ang = torch.linalg.vector_norm(se3.so3_log(Rr.transpose(-1, -2) @ Rp), dim=-1)
    return dt, float(ang.max())


@dataclasses.dataclass
class LoopCalls:
    """The calls the program's loop detector received, in order: ("detect",
    index, pose_guess, result) and ("store", index, pose_est, pose_cov).
    Points come from the reference's own inputs of that scan."""

    calls: List[tuple]
    inject_positive_only: bool  # run_chunked merges a factor only when its weight > 0


@dataclasses.dataclass
class PassRecord:
    """One pass of the program, for the comparison."""

    ref_batches: object  # the reference's inputs of every scan (reference ScanBatch), or a function giving them
    poses: np.ndarray  # (n, 6), the program's
    tapes: Dict[str, np.ndarray]  # ScanTape field -> (n, ...), the program's
    states: Dict[int, dict]  # k -> the program's state before scan k (state_tree); k = n: the final state
    segments: List[tuple]  # (first scan, scans) of each compared segment; first scan 0: from init_state
    loop: Optional[LoopCalls] = None
    decoded: Optional[list] = None  # the program's decoded batches (state_tree each), where it decoded a bag
    resume_mismatch: Optional[int] = None  # where `states` came from a second replay: its elements that differ


def reference_config(config: dict) -> rconfig.PipelineConfig:
    return rconfig.PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["pipeline"].items()})


def loop_config(config: dict) -> LoopConfig:
    return LoopConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["loop"].items()})


def _same_factor(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def replay_loop(rec: PassRecord, config: dict):
    """(factor injected at each scan by the reference's detector, mismatching
    results): the program's call sequence replayed on the reference's own
    detector and points."""
    det = LoopDetector(loop_config(config))
    inject, bad = {}, 0
    for call in rec.loop.calls:
        kind, i = call[0], call[1]
        b = rec.ref_batches[i]
        pts, w = b.points.cpu().numpy(), b.point_weights.cpu().numpy()
        if kind == "store":
            det.store(i, call[2], pts, w, call[3])
            continue
        hit = det.detect(i, call[2], pts, w)
        bad += not _same_factor(hit, call[3])
        if hit is not None and (not rec.loop.inject_positive_only or hit[2] > 0):
            inject[i] = hit
    return inject, bad


def _with_loop(batch, hit):
    def like(x, v):
        return torch.as_tensor(np.asarray(v), dtype=x.dtype, device=x.device)

    return batch._replace(loop_pose=like(batch.loop_pose, hit[0]), loop_cov=like(batch.loop_cov, hit[1]),
                          loop_weight=like(batch.loop_weight, hit[2]))


def _to(batch, device):
    return type(batch)(*[x.to(device) for x in batch])


def _cast_like(tree, like):
    """`tree`'s leaves in the dtypes of `like`'s (a program run in a lower
    precision hands over float32 beliefs; the reference runs the
    configuration's)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cast_like(v, like[k]) for k, v in tree.items()}
    return np.asarray(tree).astype(like.dtype)


def _worst(gaps: Dict[str, float], n: int = 4) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


def _abs_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """max |prog - ref| over the reference's finite elements (inf where the
    shapes or the finite elements differ)."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if p.shape != r.shape or not np.array_equal(np.isfinite(p), np.isfinite(r)):
        return float("inf")
    fin = np.isfinite(r)
    return float(np.abs(p[fin] - r[fin]).max()) if fin.any() else 0.0


def compare(rec: PassRecord, config: dict, program_init: dict, device, detail=None) -> Dict[str, float]:
    """The compared numbers of one pass (see the module's docstring). Where
    `detail` is a dict, it gets the worst fields of each number, by name,
    and each segment's gaps."""
    detail = {} if detail is None else detail
    state_leaves: Dict[str, float] = {}
    rcfg = reference_config(config)
    if callable(rec.ref_batches):
        rec.ref_batches = rec.ref_batches()
    init = state_tree(rstep.init_state(rcfg, device=device))
    out = {"init_mismatch": float(mismatches(program_init, init))}
    if rec.resume_mismatch is not None:
        out["resume_mismatch"] = float(rec.resume_mismatch)
    inject = {}
    if rec.loop is not None:
        inject, bad = replay_loop(rec, config)
        out["loop_mismatch"] = float(bad)
    segs = []  # (first scan, scans, pose gap, rotation gap, the reference's tapes, leaf gaps after it)
    with torch.no_grad():
        for k, seg_len in rec.segments:
            s = rstep.init_state(rcfg, device=device) if k == 0 else rstep.state_from_numpy(_cast_like(rec.states[k], init), device)
            poses, tapes = [], []
            for i in range(k, k + seg_len):
                b = _to(rec.ref_batches[i], device)
                if i in inject:
                    b = _with_loop(b, inject[i])
                s, o = rstep.scan_step(s, b, rcfg)
                poses.append(o.pose.cpu().numpy())
                tapes.append(state_tree(o.tape))
            dt, da = pose_gaps(rec.poses[k:k + seg_len], np.stack(poses))
            gaps = {}  # leaf -> its gap after the segment's last scan, where the program's state there is known
            if k + seg_len in rec.states:
                lp, lr = dict(leaves(rec.states[k + seg_len])), dict(leaves(state_tree(s)))
                gaps = {name: rel_gap(lp[name], lr[name]) if name in lp and name in lr else float("inf")
                        for name in lp.keys() | lr.keys()}
                for name, g in gaps.items():
                    state_leaves[name] = max(state_leaves.get(name, 0.0), g)
            segs.append((k, seg_len, dt, da, {f: np.stack([t[f] for t in tapes]) for f in rec.tapes}, gaps))
    # a tape field is normalised by its largest magnitude in the reference over every compared scan; a field
    # under TAPE_FLOOR there is rounding alone and left out
    scale = {f: max(float(np.abs(r[np.isfinite(r)]).max(initial=0.0))
                    for r in (np.asarray(g[4][f], np.float64) for g in segs)) for f in rec.tapes}
    tape_fields: Dict[str, float] = {}
    seg_tape, seg_state, rows = [], [], []
    for k, seg_len, dt, da, ref_tapes, gaps in segs:
        fields = {f: _abs_gap(v[k:k + seg_len], ref_tapes[f]) / scale[f]
                  for f, v in rec.tapes.items() if scale[f] >= TAPE_FLOOR}
        for f, g in fields.items():
            tape_fields[f] = max(tape_fields.get(f, 0.0), g)
        tf = max(fields, key=fields.get, default="")
        seg_tape.append(fields.get(tf, 0.0))
        row = f"[{k}, {k + seg_len}) pose {dt:.3g} m rot {da:.3g} tape {seg_tape[-1]:.3g} ({tf})"
        if gaps:
            leaf = max(gaps, key=gaps.get)
            seg_state.append(gaps[leaf])
            row += f" state {gaps[leaf]:.3g} ({leaf})"
        rows.append(row)
    out.update(pose_gap_m=max((g[2] for g in segs), default=0.0), rot_gap_rad=max((g[3] for g in segs), default=0.0),
               tape_gap_median=float(np.median(seg_tape)) if seg_tape else 0.0,
               state_gap_median=float(np.median(seg_state)) if seg_state else 0.0)
    detail["tape_gap"], detail["state_gap"] = _worst(tape_fields), _worst(state_leaves)
    detail["widest"] = f"tape_gap {max(seg_tape, default=0.0)!r}, state_gap {max(seg_state, default=0.0)!r}"
    detail["segments"] = "; ".join(rows)
    if rec.decoded is not None:
        ref = [state_tree(b) for b in rec.ref_batches]
        fields: Dict[str, float] = {}
        for p, r in zip(rec.decoded, ref):
            for f in r.keys() | p.keys():
                g = rel_gap(p[f], r[f]) if f in p and f in r else float("inf")
                fields[f] = max(fields.get(f, 0.0), g)
        detail["decode_gap"] = _worst({k: v for k, v in fields.items() if v})
        gap = max(fields.values(), default=0.0)
        out["decode_gap"] = gap if len(ref) == len(rec.decoded) else float("inf")
    return out
