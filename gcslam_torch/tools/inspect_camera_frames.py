"""Camera-topic forensics: frames, formats, intrinsics, rgb/depth pairing.

The reference's tools/inspect_camera_frames.py:1-335: sample each camera
topic across the bag (first / middle / last + deterministic spread) and
report frame_id consistency, CompressedImage format drift, Image encodings
and sizes, CameraInfo intrinsics (fx fy cx cy, distortion), rates, and —
the part that breaks real rigs — the rgb<->depth stamp pairing: median and
max |dt| between nearest-stamp pairs, and the fraction of frames with no
partner within 20 ms (the frontend's pairing window,
frontend/rosbag.py pair_rgb_depth).

Usage:
  python -m gcslam_torch.tools.inspect_camera_frames bag.db3 [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _spread(n: int, k: int = 7):
    if n <= k:
        return list(range(n))
    return sorted({0, n // 2, n - 1, *np.linspace(0, n - 1, k).astype(int)})


def _summarize(typ: str, msgs) -> dict:
    out: dict = {"count": len(msgs)}
    t = np.asarray([cdr.header_stamp(b) for _, b in msgs])
    if len(t) > 1:
        dt = np.diff(np.sort(t))
        out["rate_hz"] = round(float(1.0 / np.median(dt)), 2) if np.median(dt) > 0 else 0.0
        out["stamps_monotonic"] = bool(np.all(np.diff(t) >= 0))
    frames, formats, encodings, sizes = set(), set(), set(), set()
    intr = None
    for i in _spread(len(msgs)):
        buf = msgs[i][1]
        try:
            if "CameraInfo" in typ:
                m = cdr.parse_camera_info(buf)
                frames.add(m.header.frame_id)
                k = np.asarray(m.k)
                intr = {"fx": round(float(k[0]), 3), "fy": round(float(k[4]), 3),
                        "cx": round(float(k[2]), 3), "cy": round(float(k[5]), 3),
                        "size": [int(m.width), int(m.height)],
                        "distortion_model": m.distortion_model,
                        "d_nonzero": bool(np.any(np.abs(np.asarray(m.d)) > 1e-12))}
            elif "CompressedImage" in typ:
                m = cdr.parse_compressed_image(buf)
                frames.add(m.header.frame_id)
                formats.add(m.format)
                sizes.add(len(m.data))
            elif "Image" in typ:
                m = cdr.parse_image(buf)
                frames.add(m.header.frame_id)
                encodings.add(m.encoding)
                sizes.add((m.width, m.height))
        except Exception as e:
            out.setdefault("parse_errors", []).append(str(e)[:100])
    out["frame_ids"] = sorted(frames)
    if formats:
        out["formats"] = sorted(formats)
    if encodings:
        out["encodings"] = sorted(encodings)
    if intr:
        out["intrinsics"] = intr
    if sizes and not intr:
        out["sample_sizes"] = sorted(sizes)[:4]
    return out


def _pairing(t_a: np.ndarray, t_b: np.ndarray, window_s: float = 0.02) -> dict:
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    j = np.where(np.abs(t_a - t_b[j - 1]) < np.abs(t_a - t_b[j]), j - 1, j)
    adt = np.abs(t_a - t_b[j])
    return {
        "median_dt_ms": round(float(np.median(adt)) * 1e3, 3),
        "max_dt_ms": round(float(adt.max()) * 1e3, 3),
        "unpaired_frac": round(float((adt > window_s).mean()), 4),
        "window_ms": window_s * 1e3,
    }


def inspect_camera_frames(bag_path: str) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    cam_types = ("Image", "CompressedImage", "CameraInfo")
    topics = {n: t for n, t in types.items()
              if any(ct in t for ct in cam_types) and raw.get(n)}
    if not topics:
        return {"error": f"no camera topics in {bag_path}",
                "topics": dict(types)}
    out: dict = {"topics": {}}
    for n, t in sorted(topics.items()):
        s = _summarize(t, raw[n])
        s["type"] = t
        out["topics"][n] = s

    # rgb<->depth pairing: color image topic vs a depth-looking image topic
    img_topics = [n for n, t in topics.items()
                  if "Image" in t and "CameraInfo" not in t]
    depth = next((n for n in img_topics if "depth" in n.lower()), None)
    color = next((n for n in img_topics
                  if n != depth and ("color" in n.lower() or "rgb" in n.lower())),
                 next((n for n in img_topics if n != depth), None))
    if depth and color:
        t_d = np.sort(np.asarray([cdr.header_stamp(b) for _, b in raw[depth]]))
        t_c = np.sort(np.asarray([cdr.header_stamp(b) for _, b in raw[color]]))
        out["rgb_depth_pairing"] = {"color": color, "depth": depth,
                                    **_pairing(t_c, t_d)}

    warnings = []
    for n, s in out["topics"].items():
        if len(s.get("frame_ids", [])) > 1:
            warnings.append(f"{n}: MULTIPLE frame_ids {s['frame_ids']}")
        if len(s.get("formats", [])) > 1:
            warnings.append(f"{n}: format drift {s['formats']}")
    pr = out.get("rgb_depth_pairing")
    if pr and pr["unpaired_frac"] > 0.05:
        warnings.append(f"rgb/depth: {pr['unpaired_frac']*100:.1f}% frames "
                        f"unpaired within {pr['window_ms']:.0f} ms")
    out["warnings"] = warnings
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = inspect_camera_frames(args.bag)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
        return 0
    for n, s in info["topics"].items():
        print(f"{n}  ({s['type']})  n={s['count']}  "
              f"{s.get('rate_hz', '?')} Hz  frames={s['frame_ids']}")
        if "intrinsics" in s:
            print(f"   intrinsics {s['intrinsics']}")
        if "formats" in s:
            print(f"   formats {s['formats']}")
        if "encodings" in s:
            print(f"   encodings {s['encodings']}")
    if "rgb_depth_pairing" in info:
        print(f"rgb/depth pairing: {info['rgb_depth_pairing']}")
    for w in info["warnings"]:
        print(f"WARNING: {w}")
    return 0 if not info["warnings"] else 1


if __name__ == "__main__":
    sys.exit(main())
