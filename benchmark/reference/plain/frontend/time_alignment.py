"""Per-topic time alignment: offset + drift vs the LiDAR reference clock
(reference config/time_alignment/*.yaml + frontend/sensors/time_alignment.py
+ tools/compute_time_alignment.py); the port's own copy of the JAX
package's frontend/time_alignment.py.

aligned_t = t * (1 + drift) + offset
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class TopicAlignment:
    """aligned_t = t + offset + drift * (t - t0) — the reference's linear
    clock model (config/time_alignment/*.yaml: offset_sec,
    drift_sec_per_sec, t0_sec)."""

    offset_sec: float = 0.0
    drift: float = 0.0  # sec per sec vs the reference clock
    t0_sec: float = 0.0

    def apply(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t)
        return t + self.offset_sec + self.drift * (t - self.t0_sec)


def load_alignment(path: str) -> Dict[str, TopicAlignment]:
    """Load a {topic: {offset_sec, drift}} profile — JSON or YAML (the
    reference ships YAML, config/time_alignment/*.yaml)."""
    from benchmark.reference.plain.models.config import read_config_mapping

    raw = read_config_mapping(path)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: alignment profile must be a mapping")
    # Reference schema: {time_alignment: {reference, window_sec, t0_sec,
    # streams: {topic: {offset_sec, drift_sec_per_sec, t0_sec}}}}.
    if "time_alignment" in raw:
        section = raw["time_alignment"]
        t0_default = float(section.get("t0_sec", 0.0))
        out = {}
        for topic, v in section.get("streams", {}).items():
            out[topic] = TopicAlignment(
                offset_sec=float(v.get("offset_sec", 0.0)),
                drift=float(v.get("drift_sec_per_sec", v.get("drift", 0.0))),
                t0_sec=float(v.get("t0_sec", t0_default)),
            )
        return out
    # Flat schema: {topic: {offset_sec, drift[, t0_sec]}}
    out = {}
    for k, v in raw.items():
        unknown = set(v) - {"offset_sec", "drift", "drift_sec_per_sec", "t0_sec"}
        if unknown:
            raise ValueError(f"{path}: unknown alignment keys for {k}: {sorted(unknown)}")
        out[k] = TopicAlignment(
            offset_sec=float(v.get("offset_sec", 0.0)),
            drift=float(v.get("drift_sec_per_sec", v.get("drift", 0.0))),
            t0_sec=float(v.get("t0_sec", 0.0)),
        )
    return out


def estimate_offset(t_a: np.ndarray, t_b: np.ndarray) -> float:
    """Median stamp offset between two roughly-corresponding streams —
    the simple estimator behind tools/compute_time_alignment.py."""
    n = min(len(t_a), len(t_b))
    if n == 0:
        return 0.0
    return float(np.median(np.asarray(t_b)[:n] - np.asarray(t_a)[:n]))
