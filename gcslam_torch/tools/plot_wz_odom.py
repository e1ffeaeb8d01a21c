"""Plot odometry yaw rate (wz): time series, integrated heading, polar view.

The reference's tools/plot_wz_odom.py:1-106 takes the odom CSV from
dump_raw_imu_odom and draws (1) heading-on-unit-circle points from
integrated wz and (2) a polar plot (angle=time, r=wz) — a quick visual for
yaw-rate sign conventions and turn structure. We accept either that CSV or
a bag directly, and add the plain wz(t) series (the most-read panel).

The three panels are written as one SVG (outputs/svg_plot.py; the GPU hosts
have no matplotlib): the wz(t) line, the heading points coloured by time
(viridis), and the polar view drawn in Cartesian form (x = |wz| cos a,
y = |wz| sin a, a = 2 pi t / T) coloured by the sign of wz (coolwarm).
--out takes a .svg path; any other suffix raises.

Usage:
  python -m gcslam_torch.tools.plot_wz_odom odom_raw_first_300.csv --out wz.svg
  python -m gcslam_torch.tools.plot_wz_odom bag.db3 --out wz.svg
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np


def load_wz(path: str, topic: str | None = None):
    """(stamps, wz) from an odom CSV (dump_raw_imu_odom layout) or a bag."""
    if path.endswith(".csv"):
        stamps, wz = [], []
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                stamps.append(float(row["stamp_sec"]))
                wz.append(float(row["wz"]))
        return np.asarray(stamps), np.asarray(wz)
    from gcslam_torch.frontend import cdr, rosbag

    raw = rosbag.read_bag_messages(path)
    types = raw.pop("__types__")
    topic = topic or next(
        (n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    if not topic or not raw.get(topic):
        raise SystemExit(f"no Odometry topic in {path}")
    msgs = [cdr.parse_odometry(b) for _, b in raw[topic]]
    return (np.asarray([m.header.stamp_sec for m in msgs]),
            np.asarray([m.twist_angular[2] for m in msgs]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help="odom CSV (dump_raw_imu_odom) or bag file")
    p.add_argument("--topic", default=None)
    p.add_argument("--out", default="wz_plots.svg")
    args = p.parse_args(argv)

    from gcslam_torch.outputs import svg_plot as sp

    sp.check_svg_path(args.out)
    t, wz = load_wz(args.input, args.topic)
    if len(t) < 2:
        print("not enough odometry samples", file=sys.stderr)
        return 1
    tt = t - t[0]
    heading = np.concatenate([[0.0], np.cumsum(wz[:-1] * np.diff(t))])
    ang = 2 * np.pi * tt / max(tt[-1], 1e-9)

    sp.write_figure(args.out, [
        sp.panel("odom yaw rate", [sp.Line(tt, wz)], xlabel="t [s]", ylabel="wz [rad/s]", w=480, hline=0.0),
        sp.panel("integrated heading (unit circle, color=time)",
                 dots=[sp.Dots(np.cos(heading), np.sin(heading), sp.ramp(tt, sp.VIRIDIS))], w=480,
                 equal_aspect=True),
        sp.panel("|wz| polar (angle=time, color=sign)",
                 dots=[sp.Dots(np.abs(wz) * np.cos(ang), np.abs(wz) * np.sin(ang),
                               sp.ramp(np.sign(wz), sp.COOLWARM, -1.0, 1.0))], w=480, equal_aspect=True),
    ], w=480)
    print(f"wrote {args.out}  (n={len(t)}, wz range "
          f"[{wz.min():.3f}, {wz.max():.3f}] rad/s, "
          f"net heading {np.degrees(heading[-1]):.1f} deg)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
