"""The port's native visual-feature stage (csrc/bag_decode.cpp,
gcslam_visual_features), written again in numpy: Shi-Tomasi min-eigen
corners on Sobel gradients in float32, a grid NMS, libstdc++'s
std::nth_element for the top max_feat, a robust (median / MAD) depth
window. g++ -O3 contracts three of the C++'s float32 expressions into
fused multiply-adds (det, disc and sigma_z); fma32 computes those with one
rounding, and every other float32 operation here rounds as it does there,
so the features, and their order, are the same bit for bit.

The reference decodes every CDR payload with the pure-Python codec
(frontend/cdr.py); resolve_native() says so to the callers that ask."""

from __future__ import annotations

import numpy as np


def resolve_native(native, what: str) -> bool:
    return False


def fma32(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding (the product of two float32 is
    exact in float64; the sum's float64 rounding error, from TwoSum, breaks a
    float32 tie that the float64 sum would land on)."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    toward = np.where(s > r64, np.inf, -np.inf).astype(np.float32)
    mid = (r64 + np.nextafter(r, toward).astype(np.float64)) * 0.5
    at_tie = (r64 != s) & (mid == s) & (err != 0)
    return np.where(at_tie, np.nextafter(s, s + err), s).astype(np.float32)


# --- libstdc++'s std::nth_element (bits/stl_algo.h, stl_heap.h), on a
# list, with the comparator `comp(a, b)` ------------------------------------

def _adjust_heap(v, first, hole, length, value, comp):
    top = hole
    child = hole
    while child < (length - 1) // 2:
        child = 2 * (child + 1)
        if comp(v[first + child], v[first + child - 1]):
            child -= 1
        v[first + hole] = v[first + child]
        hole = child
    if (length & 1) == 0 and child == (length - 2) // 2:
        child = 2 * (child + 1)
        v[first + hole] = v[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and comp(v[first + parent], value):
        v[first + hole] = v[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    v[first + hole] = value


def _make_heap(v, first, last, comp):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        _adjust_heap(v, first, parent, length, v[first + parent], comp)
        if parent == 0:
            return
        parent -= 1


def _heap_select(v, first, middle, last, comp):
    _make_heap(v, first, middle, comp)
    for i in range(middle, last):
        if comp(v[i], v[first]):
            value = v[i]
            v[i] = v[first]
            _adjust_heap(v, first, 0, middle - first, value, comp)


def _move_median_to_first(v, result, a, b, c, comp):
    if comp(v[a], v[b]):
        if comp(v[b], v[c]):
            v[result], v[b] = v[b], v[result]
        elif comp(v[a], v[c]):
            v[result], v[c] = v[c], v[result]
        else:
            v[result], v[a] = v[a], v[result]
    elif comp(v[a], v[c]):
        v[result], v[a] = v[a], v[result]
    elif comp(v[b], v[c]):
        v[result], v[c] = v[c], v[result]
    else:
        v[result], v[b] = v[b], v[result]


def _unguarded_partition(v, first, last, pivot, comp):
    while True:
        while comp(v[first], v[pivot]):
            first += 1
        last -= 1
        while comp(v[pivot], v[last]):
            last -= 1
        if not first < last:
            return first
        v[first], v[last] = v[last], v[first]
        first += 1


def _insertion_sort(v, first, last, comp):
    if first == last:
        return
    for i in range(first + 1, last):
        val = v[i]
        if comp(val, v[first]):
            v[first + 1:i + 1] = v[first:i]
            v[first] = val
        else:
            j = i
            while comp(val, v[j - 1]):
                v[j] = v[j - 1]
                j -= 1
            v[j] = val


def nth_element(v: list, nth: int, comp) -> None:
    """std::nth_element(v.begin(), v.begin() + nth, v.end(), comp) in place."""
    first, last = 0, len(v)
    if first == last or nth == last:
        return
    depth_limit = 2 * ((last - first).bit_length() - 1)
    while last - first > 3:
        if depth_limit == 0:
            _heap_select(v, first, nth + 1, last, comp)
            v[first], v[nth] = v[nth], v[first]
            return
        depth_limit -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(v, first, first + 1, mid, last - 1, comp)
        cut = _unguarded_partition(v, first + 1, last, first, comp)
        if cut <= nth:
            first = cut
        else:
            last = cut
    _insertion_sort(v, first, last, comp)


# --- the feature stage -------------------------------------------------------

def _scores(g: np.ndarray) -> np.ndarray:
    """The Shi-Tomasi score image (float32, zero on the 3-pixel border)."""
    H, W = g.shape
    B = 3
    gi = g.astype(np.int32)
    score = np.zeros((H, W), np.float32)
    # Sobel at every pixel whose 3 x 3 window is read: rows / cols 2 .. H-3

    def at(dy, dx):
        return gi[2 + dy:H - 2 + dy, 2 + dx:W - 2 + dx]

    gx = (at(0, 1) - at(0, -1)) * 2 + (at(-1, 1) - at(-1, -1)) + (at(1, 1) - at(1, -1))
    gy = (at(1, 0) - at(-1, 0)) * 2 + (at(1, -1) - at(-1, -1)) + (at(1, 1) - at(-1, 1))
    # products and 9-term sums of integers below 2**24: exact in float32
    pxx, pyy, pxy = (gx * gx).astype(np.int64), (gy * gy).astype(np.int64), (gx * gy).astype(np.int64)
    h, w = gx.shape  # pixel (y, x) of the image is (y - 2, x - 2) here

    def win(p):
        out = np.zeros((h - 2, w - 2), np.int64)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out += p[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
        return out.astype(np.float32)

    sxx, syy, sxy = win(pxx), win(pyy), win(pxy)  # pixels 3 .. H-4
    tr = np.float32(0.5) * (sxx + syy)
    det = fma32(sxx, syy, -(sxy * sxy))
    disc = fma32(tr, tr, -det)
    mineig = tr - np.sqrt(np.where(disc > np.float32(0.0), disc, np.float32(0.0)))
    score[B:H - B, B:W - B] = mineig / np.float32(255.0 * 255.0 * 36.0)
    return score


def visual_features(gray_u8, depth_f32, max_feat: int = 512, min_score: float = 5e-4, nms_radius: int = 6):
    """(n, uv (F, 2), score (F,), z (F,), z_var (F,), normal_duv1 (F, 3),
    gray01 (F,)), all float32, the first n rows features: the port's
    native.visual_features, computed here."""
    g = np.ascontiguousarray(gray_u8, dtype=np.uint8)
    d = np.ascontiguousarray(depth_f32, dtype=np.float32)
    H, W = g.shape
    F = int(max_feat)
    uv = np.zeros((F, 2), np.float32)
    score_o, z_o, zvar_o, color_o = (np.zeros(F, np.float32) for _ in range(4))
    normal_o = np.zeros((F, 3), np.float32)
    if W < 8 or H < 8 or F <= 0:
        return 0, uv, score_o, z_o, zvar_o, normal_o, color_o
    B = 3
    score = _scores(g)
    thr = np.float32(min_score)
    cell = 2 * nms_radius + 1 if nms_radius > 0 else 7
    cands = []
    for cy in range(B, H - B, cell):
        ye = min(cy + cell, H - B)
        for cx in range(B, W - B, cell):
            xe = min(cx + cell, W - B)
            blk = score[cy:ye, cx:xe]
            k = int(np.argmax(blk))  # the first maximum in row-major order
            s = blk.flat[k]
            if s > thr:
                cands.append((s, cx + k % (xe - cx), cy + k // (xe - cx)))
    if len(cands) > F:
        nth_element(cands, F, lambda a, b: a[0] > b[0])
        cands = cands[:F]

    n = 0
    f32 = np.float32
    for s, x0, y0 in cands:
        if n >= F:
            break
        win = d[max(y0 - 3, 0):min(y0 + 4, H), max(x0 - 3, 0):min(x0 + 4, W)]
        zs = win[(win > 0) & np.isfinite(win)]  # row-major, as the C++ pushes them
        if zs.size < 8:
            continue
        zs = np.sort(zs)
        zmed = zs[zs.size // 2]
        dev = np.sort(np.abs(zs - zmed))
        mad = dev[dev.size // 2]
        sigma_z = fma32(1.4826, mad, 1e-4)[()]
        # the C++'s depth-plane fit gives the normal only, which the port drops
        uv[n] = (x0, y0)
        score_o[n] = s
        z_o[n] = zmed
        zvar_o[n] = f32(sigma_z * sigma_z)
        normal_o[n] = (0.0, 0.0, 1.0)
        color_o[n] = f32(g[y0, x0]) / f32(255.0)
        n += 1
    return n, uv, score_o, z_o, zvar_o, normal_o, color_o
