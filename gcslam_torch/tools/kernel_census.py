"""Census of what one scan of the production step launches, and which
function of the port launches it (counterpart of the JAX package's
tools/hlo_census.py, which counts the instructions of the compiled XLA
program: an eager step has no program, so this counts what it runs).

After a warm-up replay of all scans but the last, the last scan runs once
under torch.profiler and under a dispatch mode that wraps every aten op
the step dispatches in a profiler range, and records its caller (the
innermost gcslam_torch frame of the Python stack at dispatch) and whether
all its outputs are 0-d. Each launch is the op's whose range holds it.
(torch.profiler's own `with_stack=True` records every Python call as an
event: 2.3M events a SMALL scan on the CPU, minutes to parse.) On the
CUDA card it reports:

  - launch_calls_per_scan: the runtime's kernel-launch calls, as
    utils/cuda_profile counts them for the on-card smoke script and
    tools/attribute_step;
  - device_kernels_per_scan and kernel_families_top20: the kernels the
    device ran, by name family (template arguments and namespaces cut);
  - d2d_copies and d2d_copy_bytes: the device-to-device copies (the
    functional updates' copies, the JAX tool's body_copies), the bytes
    being the outputs of the ops that made them;
  - scalar_output_launches: launches by aten ops whose outputs are all 0-d
    tensors (the certificate plumbing; the JAX tool's body_scalar_ops);
  - top_functions: launches, aten ops and device microseconds by the
    function of gcslam_torch that issued them (file:function), the top 25
    by launches (the JAX tool's attribution by op_name);
    attributed_launches counts the launches that have such a function;
  - lie_launches_by_op: the launches of csrc/se3.cu's Lie-group kernel in
    the scan by op (ops/se3.LIE_COUNTER): one a call of the SO(3)/SE(3)
    maps and of linalg.inv3x3, which shows that the step goes through the
    kernel.
On the CPU it reports the dispatched aten ops, the 0-d ones and the same
attribution by aten ops, with the device columns None and no Lie
launches (there each such call is the one op gcslam::lie or
gcslam::inv3x3, whose plain version runs inside it).

--replay profiles run_bag over the last scan (the replay path: the bag's
commit to the device and the output stacking with the step) in place of
one scan_step call.

Usage:
  python -m gcslam_torch.tools.kernel_census [--cpu] [--replay] [--scans 10]
         [--points N] [--json PATH] [--set KEY=VAL ...]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import re
import sys
import time
from pathlib import Path

TOP_FUNCTIONS = 25
MARK = "gcslam_census#"
PACKAGE = Path(__file__).resolve().parents[1]
# frames that are the census's own machinery, not the step's
OWN_FRAMES = ("gcslam_torch/tools/kernel_census.py", "gcslam_torch/utils/cuda_profile.py")


def family(kernel: str) -> str:
    """A kernel's name without its return type, template arguments,
    parameters and namespaces."""
    name = kernel.replace("(anonymous namespace)::", "")
    while True:
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            break
        name = shorter
    name = name.split("(")[0].strip()
    return name.split()[-1].rsplit("::", 1)[-1] if name else kernel


_FRAMES = {}  # code object -> its "file:function" when it is a frame of the step, else None


def _step_frame(code):
    if code not in _FRAMES:
        path = Path(code.co_filename)
        rel = (f"gcslam_torch/{path.relative_to(PACKAGE).as_posix()}" if path.is_relative_to(PACKAGE) else "")
        _FRAMES[code] = f"{rel}:{code.co_name}" if rel and not rel.startswith(OWN_FRAMES) else None
    return _FRAMES[code]


def _caller() -> str:
    """file:function of the innermost gcslam_torch frame on the Python
    stack (the census's own frames skipped)."""
    f = sys._getframe(1)
    while f is not None:
        name = _step_frame(f.f_code)
        if name is not None:
            return name
        f = f.f_back
    return "(outside gcslam_torch)"


def _marking_mode():
    """A dispatch mode that wraps every dispatched aten op k in a profiler
    range MARK<k> and records its caller, whether all its outputs are 0-d
    and their bytes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Marks(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.caller = []
            self.scalar = []
            self.out_bytes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            k = len(self.scalar)
            self.caller.append(_caller())
            with torch.profiler.record_function(f"{MARK}{k}"):
                out = func(*args, **(kwargs or {}))
            outs = [out] if isinstance(out, torch.Tensor) else [x for x in tree_leaves(out)
                                                                if isinstance(x, torch.Tensor)]
            self.scalar.append(bool(outs) and all(x.dim() == 0 for x in outs))
            self.out_bytes.append(sum(x.nbytes for x in outs))
            return out

    return Marks()


def census(fn, cuda: bool) -> dict:
    """Profile fn() (one scan) and count what it dispatched and launched."""
    from gcslam_torch.ops import se3
    from gcslam_torch.utils import cuda_profile

    marks = _marking_mode()
    lie_before = se3.LIE_COUNTER.snapshot()

    def marked():
        with marks:
            fn()

    prof, span_ms = cuda_profile.profile(marked, ("cpu", "cuda") if cuda else ("cpu",))
    rows = collections.defaultdict(lambda: {"aten_ops": 0, "launches": 0, "device_us": 0.0})
    for caller in marks.caller:
        rows[caller]["aten_ops"] += 1
    report = {
        "aten_ops": len(marks.scalar),
        "scalar_output_ops": sum(marks.scalar),
        "profiled_span_ms": span_ms,
        "launch_calls_per_scan": None,
        "scalar_output_launches": None,
        "device_kernels_per_scan": None,
        "kernel_families_top20": None,
        "d2d_copies": None,
        "d2d_copy_bytes": None,
        "device_us": None,
        "attributed_launches": None,
        "lie_launches_by_op": se3.launches_by_op(since=lie_before),
    }
    if cuda:
        report.update(_device_columns(prof, marks, rows))
    key = "launches" if cuda else "aten_ops"
    top = sorted(rows.items(), key=lambda kv: -kv[1][key])[:TOP_FUNCTIONS]
    report["top_functions"] = [{"function": f, **{k: (v if cuda or k == "aten_ops" else None) for k, v in r.items()}}
                               for f, r in top]
    return report


def _device_columns(prof, marks, rows) -> dict:
    """Launches, kernels, copies and device time of the trace, each given
    to the op whose MARK range holds it: a launch call lies in its op's
    range in time; a device activity links to the aten op that launched it
    (linked_correlation_id), which starts in its op's range."""
    from torch.autograd import DeviceType

    from gcslam_torch.utils import cuda_profile

    events = cuda_profile.raw_events(prof)
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), int(e.name()[len(MARK):]))
                    for e in cpu if e.name().startswith(MARK))
    starts = [r[0] for r in ranges]

    def op_at(t_ns):
        i = bisect.bisect_right(starts, t_ns) - 1
        return ranges[i][2] if i >= 0 and t_ns < ranges[i][1] else None

    def caller(k):
        return "(outside the step's ops)" if k is None else marks.caller[k]

    # the host ops (a runtime call or device activity links to one; they
    # link to none), by id
    op_start = {e.correlation_id(): e.start_ns() for e in cpu if e.linked_correlation_id() == 0}
    launches = scalar_launches = 0
    for e in cpu:
        if cuda_profile.is_launch(e.name()):
            k = op_at(e.start_ns())
            launches += 1
            rows[caller(k)]["launches"] += 1
            scalar_launches += bool(k is not None and marks.scalar[k])
    families = collections.Counter()
    copies, copy_ops, device_us = 0, set(), 0.0
    for e in cuda_profile.device_activity(events):
        if e.name().startswith(MARK):
            continue  # a MARK range's device-side annotation
        start = op_start.get(e.linked_correlation_id())
        k = None if start is None else op_at(start)
        us = e.duration_ns() / 1e3
        device_us += us
        rows[caller(k)]["device_us"] += us
        if e.name().startswith("Memcpy DtoD"):
            copies += 1
            copy_ops.add(k)
        elif not e.name().startswith(cuda_profile.NOT_KERNELS):
            families[family(e.name())] += 1
    return dict(launch_calls_per_scan=launches, scalar_output_launches=scalar_launches,
                device_kernels_per_scan=sum(families.values()), kernel_families_top20=dict(families.most_common(20)),
                d2d_copies=copies, d2d_copy_bytes=sum(marks.out_bytes[k] for k in copy_ops if k is not None),
                device_us=device_us, attributed_launches=sum(r["launches"] for f, r in rows.items()
                                                             if not f.startswith("(")))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--replay", action="store_true",
                    help="census run_bag over the last scan instead of one scan_step call")
    ap.add_argument("--scans", type=int, default=10, help="scans generated; all but the last warm up")
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="PipelineConfig overrides (JSON values), e.g. --set with_map=false")
    args = ap.parse_args(argv)
    if args.scans < 2:
        raise SystemExit("--scans must be >= 2 (one warm-up scan and the census scan)")

    import torch

    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_step import scan_step
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = json.loads(v)
    cfg = PipelineConfig(**overrides)
    cfg.validate()
    run = generate(SyntheticConfig(n_scans=args.scans, n_points=args.points or cfg.n_points_cap), device=device)
    state, _ = runner.run_bag(run.batches[:-1], cfg, device=device)
    last = run.batches[-1]
    if args.replay:
        def one_scan():
            runner.run_bag([last], cfg, state=state, device=device)
    else:
        batch = last.to(device)

        def one_scan():
            with torch.no_grad():
                scan_step(state, batch, cfg)
    t0 = time.perf_counter()
    rep = census(one_scan, device.type == "cuda")
    rep.update(backend=device.type, device_name=(torch.cuda.get_device_name(device) if device.type == "cuda"
                                                 else "cpu"),
               program="replay" if args.replay else "step", scans=args.scans, profiled_scans=1,
               config_overrides=overrides, census_s=time.perf_counter() - t0)
    out = json.dumps(rep, indent=1)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    return rep


if __name__ == "__main__":
    main()
