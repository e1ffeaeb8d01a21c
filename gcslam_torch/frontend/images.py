"""RGB-D image decode + pairing (counterpart of the JAX package's
frontend/images.py) — the offline equivalent of the reference's C++ camera
I/O node (src/camera_rgbd_node.cpp:49-361): JPEG decode of CompressedImage
RGB, 16UC1-mm -> 32FC1-m depth scaling, and greedy timestamp pairing at
<= pair_max_dt_sec (reference default 0.05 s, camera_rgbd_node.cpp:226).

Compressed frames decode with PIL on the host: the port's native decoder
(csrc/bag_decode.cpp) leaves out the JAX package's libjpeg route because
the GPU hosts it runs on have no libjpeg headers.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gcslam_torch.frontend import cdr


def decode_compressed(msg: cdr.CompressedImage) -> np.ndarray:
    """CompressedImage (JPEG, PNG) -> (H, W, 3) uint8 RGB.

    The ROS `format` string declares the pre-compression channel order
    (e.g. "bgr8; jpeg compressed bgr8"); the decoder returns the stored
    order, so a declared bgr8 source needs a channel swap to RGB.
    """
    import io

    from PIL import Image as PILImage

    arr = np.asarray(PILImage.open(io.BytesIO(msg.data)).convert("RGB"))
    fmt = msg.format.lower()
    # "rgb8; jpeg compressed bgr8": the part AFTER "compressed" names the
    # stored order (cv_bridge convention); else the leading token.
    stored = fmt.split("compressed", 1)[1] if "compressed" in fmt else fmt
    if "bgr" in stored:
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)


def image_to_array(msg: cdr.Image) -> np.ndarray:
    """Raw sensor_msgs/Image -> numpy array in the message's encoding."""
    enc = msg.encoding.lower()
    end = ">" if msg.is_bigendian else "<"
    dtypes = {
        "rgb8": (np.uint8, 3),
        "bgr8": (np.uint8, 3),
        "mono8": (np.uint8, 1),
        "8uc1": (np.uint8, 1),
        "mono16": (np.dtype(end + "u2"), 1),
        "16uc1": (np.dtype(end + "u2"), 1),
        "32fc1": (np.dtype(end + "f4"), 1),
    }
    if enc not in dtypes:
        raise ValueError(f"unsupported Image encoding {msg.encoding!r}")
    dt, ch = dtypes[enc]
    dt = np.dtype(dt)
    row = np.frombuffer(msg.data, dtype=np.uint8).reshape(msg.height, msg.step)
    arr = row[:, : msg.width * ch * dt.itemsize].copy().view(dt)
    arr = arr.reshape(msg.height, msg.width, ch)
    if enc == "bgr8":
        arr = arr[:, :, ::-1]
    return arr[:, :, 0] if ch == 1 else arr


def depth_to_meters(msg: cdr.Image, depth_scale_16u: float = 0.001) -> np.ndarray:
    """Depth Image -> (H, W) float32 meters, 0 = invalid (reference
    camera_rgbd_node.cpp:175-224: 16UC1 mm -> 32FC1 m; NaN -> 0)."""
    arr = image_to_array(msg)
    enc = msg.encoding.lower()
    if enc in ("16uc1", "mono16"):
        out = arr.astype(np.float32) * np.float32(depth_scale_16u)
    elif enc == "32fc1":
        out = np.nan_to_num(arr.astype(np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    else:
        raise ValueError(f"depth image must be 16UC1/mono16/32FC1, got {msg.encoding!r}")
    return np.where(out > 0.0, out, 0.0).astype(np.float32)


def pair_rgbd(rgb_stamps: np.ndarray, depth_stamps: np.ndarray, max_dt: float = 0.05) -> List[Tuple[int, int, float]]:
    """Greedy nearest-timestamp pairing (reference try_publish_pair,
    camera_rgbd_node.cpp:226-300): each RGB frame pairs with the closest
    unused depth frame within max_dt. Returns [(rgb_i, depth_j, t_pair)]
    sorted by time; t_pair is the RGB stamp (the feature clock)."""
    pairs: List[Tuple[int, int, float]] = []
    if len(rgb_stamps) == 0 or len(depth_stamps) == 0:
        return pairs
    d_used = np.zeros(len(depth_stamps), dtype=bool)
    ds = np.asarray(depth_stamps)
    for ri in np.argsort(rgb_stamps):
        t = rgb_stamps[ri]
        j = int(np.argmin(np.where(d_used, np.inf, np.abs(ds - t))))
        if not d_used[j] and abs(ds[j] - t) <= max_dt:
            d_used[j] = True
            pairs.append((int(ri), j, float(t)))
    pairs.sort(key=lambda p: p[2])
    return pairs


def to_gray01(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) float32 luma in [0, 1]."""
    r = rgb[:, :, 0].astype(np.float32)
    g = rgb[:, :, 1].astype(np.float32)
    b = rgb[:, :, 2].astype(np.float32)
    return (0.299 * r + 0.587 * g + 0.114 * b) / 255.0
