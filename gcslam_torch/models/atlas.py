"""Device-resident tiled primitive atlas + the map side of the scan step
(counterpart of the JAX package's models/atlas.py).

The atlas is a fixed-capacity structure of arrays:

    tile table:  tile_ids (T,) int64 (-1 empty), LRU stamps (T,)
    primitives:  (T, M_TILE, ...) — Gaussian info form (Lambda, theta),
                 multi-lobe vMF etas, mass/recency/provenance/color

and every map operation — tile allocation, recency inflation, view
extraction, OT association + GN rounds, fuse, insert-with-eviction, cull,
forget, merge-reduce — is a fixed-shape gather/scatter over the active-tile
stencil. Functions return new tensors and never write into the atlas they
were given. Out-of-range scatter rows go to an explicit sentinel row
(ops/binned), and all top-k choices break ties to the lowest index.

On a ("run", "map") mesh (parallel/mesh.py) the functions that touch the
atlas take `shard`, this rank's place on the "map" axis, and the atlas
holds this rank's contiguous block of the tiles of every (T, M, ...)
payload channel. Reads at given slots gather each row from its owner
(ops/collectives.gather_rows); writes land on the owner alone
(ops/collectives.write_rows, the sentinel-row pattern); the one
whole-atlas reduction, valid_total, sums over "map"; fuse, insert, cull and merge work on the gathered slab. The
tile table (tile_ids, tile_last_active) and next_global_id stay whole on
every rank: allocate_tiles is a sequential LRU decision over all T slots,
and the table is 2 x T small ints. (The JAX package shards the table
too.) With shard=None nothing changes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gcslam_torch import constants as C
from gcslam_torch.models.batch import MeasurementBatch, from_camera_and_surfels, mean_positions
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import association as assoc_mod
from gcslam_torch.ops import certs as CT
from gcslam_torch.ops import collectives, evidence_pose, linalg, se3, tiling
from gcslam_torch.ops.association import topk_lowest_index
from gcslam_torch.ops.binned import scatter_accumulate, scatter_set, take_rows
from gcslam_torch.ops.se3 import mv
from gcslam_torch.ops.surfels import extract_surfels
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, POINT_DTYPE, TIME_DTYPE

MAPF = POINT_DTYPE  # map storage dtype


class AtlasState(NamedTuple):
    tile_ids: torch.Tensor  # (T,) int64, -1 = empty
    tile_last_active: torch.Tensor  # (T,) int32 scan_seq for LRU
    Lambdas: torch.Tensor  # (T, M, 3, 3)
    thetas: torch.Tensor  # (T, M, 3)
    etas: torch.Tensor  # (T, M, B, 3)
    weights: torch.Tensor  # (T, M)
    timestamps: torch.Tensor  # (T, M) TIME_DTYPE
    created: torch.Tensor  # (T, M) TIME_DTYPE
    last_supported: torch.Tensor  # (T, M) int32
    last_update: torch.Tensor  # (T, M) int32
    primitive_ids: torch.Tensor  # (T, M) int32, -1 invalid
    valid: torch.Tensor  # (T, M) bool
    cam_mass: torch.Tensor  # (T, M)
    lidar_mass: torch.Tensor  # (T, M)
    rgb_accum: torch.Tensor  # (T, M, 3)
    rgb_denom: torch.Tensor  # (T, M)
    rgb: torch.Tensor  # (T, M, 3)
    next_global_id: torch.Tensor  # () int32


# the tile table: whole on every rank of a map mesh (every other field is a
# (T, M, ...) payload channel, split in tile blocks over "map")
TABLE_FIELDS = ("tile_ids", "tile_last_active", "next_global_id")

# fill value of each per-slot channel in an empty slot
_SLOT_FILL = {"primitive_ids": -1, "valid": False, "rgb": 0.5}


def empty_atlas(cfg: PipelineConfig, device=None) -> AtlasState:
    T, M, B = cfg.atlas_max_tiles, cfg.m_tile, C.VMF_N_LOBES

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return AtlasState(
        tile_ids=full((T,), -1, torch.int64),
        tile_last_active=full((T,), -1, torch.int32),
        Lambdas=full((T, M, 3, 3), 0.0, MAPF),
        thetas=full((T, M, 3), 0.0, MAPF),
        etas=full((T, M, B, 3), 0.0, MAPF),
        weights=full((T, M), 0.0, MAPF),
        timestamps=full((T, M), 0.0, TIME_DTYPE),
        created=full((T, M), 0.0, TIME_DTYPE),
        last_supported=full((T, M), 0, torch.int32),
        last_update=full((T, M), 0, torch.int32),
        primitive_ids=full((T, M), -1, torch.int32),
        valid=full((T, M), False, torch.bool),
        cam_mass=full((T, M), 0.0, MAPF),
        lidar_mass=full((T, M), 0.0, MAPF),
        rgb_accum=full((T, M, 3), 0.0, MAPF),
        rgb_denom=full((T, M), 0.0, MAPF),
        rgb=full((T, M, 3), 0.5, MAPF),
        next_global_id=full((), 0, torch.int32),
    )


# ---------------------------------------------------------------------------
# Tile table
# ---------------------------------------------------------------------------


def lookup_tiles(atlas: AtlasState, query_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S,) int64 -> (slot (S,), found (S,) bool). Misses return slot 0."""
    eq = atlas.tile_ids[None, :] == query_ids[:, None]
    found = eq.any(1)
    slot = torch.argmax(eq.to(torch.int8), dim=1)
    return torch.where(found, slot, 0), found


def allocate_tiles(
    atlas: AtlasState, query_ids: torch.Tensor, scan_seq: torch.Tensor, shard=None
) -> Tuple[AtlasState, torch.Tensor]:
    """Give every query tile id a table slot: existing match > empty slot >
    least-recently-active eviction; newly claimed slots are cleared."""
    S = query_ids.shape[0]
    T = atlas.tile_ids.shape[0]
    tile_ids = atlas.tile_ids.clone()
    last_active = atlas.tile_last_active.clone()
    seq = scan_seq.to(torch.int32).reshape(1)
    slots, was_new = [], []
    for i in range(S):  # sequential: query i+1 must not evict what query i claimed
        qid = query_ids[i]
        eq = tile_ids == qid
        found = eq.any()
        match_slot = torch.argmax(eq.to(torch.int8))
        score = torch.where(tile_ids >= 0, last_active, -2_000_000_000)
        victim = torch.argmin(score)
        slot = torch.where(found, match_slot, victim).reshape(1)
        tile_ids.index_put_((slot,), qid.reshape(1))
        last_active.index_put_((slot,), seq)
        slots.append(slot)
        was_new.append(~found)
    slots = torch.cat(slots)
    clear = torch.where(torch.stack(was_new), slots, T)

    def cleared(name):
        x = getattr(atlas, name)
        fill = _SLOT_FILL.get(name, 0)
        rows = torch.full((S,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
        return scatter_set(x, clear, rows) if shard is None else collectives.write_rows(x, clear, rows, shard)

    atlas = atlas._replace(
        tile_ids=tile_ids,
        tile_last_active=last_active,
        **{name: cleared(name) for name in _Slab._fields},
    )
    return atlas, slots


def _read_slots(atlas: AtlasState, names, slots: torch.Tensor, shard) -> dict:
    """{name: atlas.<name>[slots]} (from the owners on a map mesh)."""
    if shard is None:
        return {n: getattr(atlas, n)[slots] for n in names}
    return dict(zip(names, collectives.gather_rows([getattr(atlas, n) for n in names], slots, shard)))


def recency_inflate(
    atlas: AtlasState, tile_slots: torch.Tensor, scan_seq: torch.Tensor, cfg: PipelineConfig, shard=None
) -> Tuple[AtlasState, torch.Tensor]:
    """Mean-preserving precision downscale of stale primitives in the given
    (distinct) tiles: decay = clip(exp(-lambda dt_scan), min_scale, 1)."""
    rows = _read_slots(atlas, ("last_supported", "valid"), tile_slots, shard)
    dt = torch.clamp(scan_seq.to(torch.int32) - rows["last_supported"], min=0)
    decay = torch.exp(-cfg.recency_decay_lambda * dt.to(MAPF))
    decay = torch.clamp(decay, cfg.recency_min_scale, 1.0)
    valid = rows["valid"]
    decay = torch.where(valid, decay, 1.0)
    if shard is None:
        Lam = atlas.Lambdas.clone()
        Lam[tile_slots] = Lam[tile_slots] * decay[..., None, None]
        th = atlas.thetas.clone()
        th[tile_slots] = th[tile_slots] * decay[..., None]
    else:  # this rank's rows scaled and written back; the rows it does not own drop
        local = torch.clamp(tile_slots - shard.index * atlas.Lambdas.shape[0], 0, atlas.Lambdas.shape[0] - 1)
        Lam = collectives.write_rows(atlas.Lambdas, tile_slots, atlas.Lambdas[local] * decay[..., None, None], shard)
        th = collectives.write_rows(atlas.thetas, tile_slots, atlas.thetas[local] * decay[..., None], shard)
    downscale = torch.sum((1.0 - decay) * valid.to(MAPF))
    return atlas._replace(Lambdas=Lam, thetas=th), downscale


class AtlasView(NamedTuple):
    """Fixed-size candidate pool over the stencil tiles; pool row
    p = tile_pos * m_view + k."""

    positions: torch.Tensor  # (P, 3) world, f64
    directions: torch.Tensor  # (P, 3)
    kappas: torch.Tensor  # (P,)
    weights: torch.Tensor  # (P,)
    valid: torch.Tensor  # (P,) bool
    primitive_ids: torch.Tensor  # (P,)
    last_supported: torch.Tensor  # (P,)
    tile_slot: torch.Tensor  # (P,) atlas tile-table slot
    slot: torch.Tensor  # (P,) slot within tile
    lidar_frac: Optional[torch.Tensor] = None  # (P,)


_VIEW_FIELDS = ("weights", "valid", "Lambdas", "thetas", "etas", "cam_mass", "lidar_mass", "primitive_ids",
                "last_supported")


def extract_view(
    atlas: AtlasState, tile_slots: torch.Tensor, tile_found: torch.Tensor, cfg: PipelineConfig, shard=None
) -> AtlasView:
    """Top m_tile_view slots per stencil tile by weight, stitched into one pool."""
    V = cfg.m_tile_view
    rows = _read_slots(atlas, _VIEW_FIELDS, tile_slots, shard)
    w = rows["weights"]
    valid = rows["valid"] & tile_found[:, None]
    _, top = topk_lowest_index(torch.where(valid, w, -torch.inf), V)

    def g(name):
        return take_rows(rows[name], top)

    f64 = BELIEF_DTYPE
    Lam64 = g("Lambdas").reshape(-1, 3, 3).to(f64) + C.EPS_LIFT * torch.eye(3, dtype=f64, device=w.device)
    pos = linalg.solve3x3(Lam64, g("thetas").reshape(-1, 3).to(f64))
    eta_sum = g("etas").reshape(-1, C.VMF_N_LOBES, 3).to(f64).sum(1)
    kap = torch.linalg.vector_norm(eta_sum, dim=-1)
    cm, lm = g("cam_mass"), g("lidar_mass")
    return AtlasView(
        positions=pos,
        directions=eta_sum / (kap[:, None] + C.EPS_MASS),
        kappas=kap,
        weights=take_rows(w, top).reshape(-1).to(f64),
        valid=take_rows(valid, top).reshape(-1),
        primitive_ids=g("primitive_ids").reshape(-1),
        last_supported=g("last_supported").reshape(-1),
        tile_slot=torch.repeat_interleave(tile_slots, V),
        slot=top.reshape(-1),
        lidar_frac=(lm / (cm + lm + C.EPS_MASS)).reshape(-1).to(f64),
    )


# ---------------------------------------------------------------------------
# Map evidence (steps 7-8): extraction, shortlist and the GN chain
# ---------------------------------------------------------------------------


class MapExtras(NamedTuple):
    """Map-branch products for the map update (fields may carry a leading
    hypothesis dim on the per-hypothesis GN path)."""

    batch: MeasurementBatch
    responsibilities: torch.Tensor  # (N, K)
    cand_pool: torch.Tensor  # (N, K) pool rows
    row_masses: torch.Tensor  # (N,)
    ot_transport_mass: torch.Tensor
    ot_marginal_defect_a: torch.Tensor
    z_map_pose: torch.Tensor  # (6,) pose the factor is linearized at
    lidar_residuals: torch.Tensor  # (N, K, 3)
    lidar_resid_w: torch.Tensor  # (N, K)


def build_measurement_inputs(
    deskewed_points, point_stamps, deskewed_weights, batch_in, atlas_view: AtlasView,
    z_center, cfg: PipelineConfig, sensor_var=None,
):
    """Surfel extraction + measurement batch + distance shortlist at
    z_center; returns (mbatch, CandidateSet or None when k_shortlist = 0,
    surfel cert). The batch's camera rows come first when cfg.with_camera
    and are dropped otherwise (zero-weight rows would change nothing but the
    shapes)."""
    surfels, surf_cert = extract_surfels(
        deskewed_points, point_stamps, deskewed_weights,
        cfg.n_surfel, cfg.surfel_voxel_size_m, cfg.surfel_min_points_per_voxel,
        sensor_var=sensor_var,
    )
    b = batch_in
    n_cam = b.cam_valid.shape[0] if cfg.with_camera else 0
    mbatch = from_camera_and_surfels(
        b.cam_Lambdas[:n_cam], b.cam_thetas[:n_cam], b.cam_etas[:n_cam], b.cam_weights[:n_cam],
        b.cam_colors[:n_cam], b.cam_valid[:n_cam], b.t_scan,
        surfels.positions, surfels.Lambdas, surfels.normals, surfels.kappas,
        surfels.weights, surfels.timestamps, surfels.valid,
    )
    if cfg.k_shortlist == 0:
        return mbatch, None, surf_cert
    R_sl = se3.so3_exp(z_center[3:6])
    mpos_w = mean_positions(mbatch, cfg.eps_lift) @ R_sl.T + z_center[None, :3]
    sl_idx = assoc_mod.shortlist_candidates(mpos_w, mbatch.valid, atlas_view, cfg)
    return mbatch, assoc_mod.gather_candidates(atlas_view, sl_idx), surf_cert


def stack_measurement_inputs(inputs):
    """Per-hypothesis (mbatch, shortlist, surfel cert) triples stacked along
    a new leading hypothesis dim."""
    def stk(parts):
        return None if parts[0] is None else type(parts[0])(*[
            None if xs[0] is None else torch.stack(xs) for xs in zip(*parts)])

    mbs, sls, certs = zip(*inputs)
    return stk(mbs), stk(sls), stk(certs)


def expand_measurement_inputs(inputs, k: int):
    """A shared (mbatch, shortlist, surfel cert) seen by k hypotheses: a
    leading dim of size k over the same storage (no copy)."""
    def exp(t):
        return None if t is None else type(t)(*[None if x is None else x.expand((k,) + x.shape) for x in t])

    return tuple(exp(t) for t in inputs)


def make_map_evidence_fn(atlas_view: AtlasView, cfg: PipelineConfig, scan_seq, sensor_var, shared=None):
    """The per-hypothesis map branch (map_gn_shared=False), called by the
    scan step after every hypothesis has its z_lin: `fn(points_k, weights,
    batch_in, z_lin_world (K, 6)) -> (L, h, certs, MapExtras)`, all with a
    leading K dim. Without `shared`, each hypothesis k extracts its own
    surfels from its deskewed points points_k[k] and takes its shortlist at
    its own z_lin (a loop over K); with `shared` = (mbatch, shortlist,
    surfel cert) from the hypothesis-0 pre-pass, every hypothesis uses that
    extraction. The GN rounds then run for all hypotheses at once — one
    batched Sinkhorn launch per round."""

    def map_evidence(points_k, deskewed_weights, batch_in, z_lin_world):
        K = z_lin_world.shape[0]
        if shared is not None:
            mbatch, shortlist, surf_cert = expand_measurement_inputs(shared, K)
            surf_cert = CT.with_triggers(surf_cert, CT.TRIGGERS["hyp_shared_extraction"])
        else:
            mbatch, shortlist, surf_cert = stack_measurement_inputs([
                build_measurement_inputs(points_k[k], batch_in.point_stamps, deskewed_weights, batch_in,
                                         atlas_view, z_lin_world[k], cfg, sensor_var)
                for k in range(K)])
        return map_gn_evidence(mbatch, shortlist, surf_cert, atlas_view, scan_seq, z_lin_world, cfg)

    return map_evidence


def map_gn_evidence(mbatch, shortlist, surf_cert, atlas_view: AtlasView,
                    scan_seq, z_start, cfg: PipelineConfig):
    """Coarse-to-fine Gauss-Newton rounds: round r associates with
    ot_epsilon * factor^(R-1-r) (Cauchy scale by the square root), takes a
    trust-region step except on the final round, whose factor — linearized
    at its own pose — is returned. The anneal schedule is static Python.
    The measurement inputs and z_start may carry a leading hypothesis dim:
    each hypothesis then runs its own chain, and each round's association
    is one batched call (shortlist None = the full-pool association)."""
    n_rounds = max(1, cfg.map_icp_iters)
    z = z_start
    for it in range(n_rounds):
        anneal = cfg.map_icp_coarse_factor ** (n_rounds - 1 - it)
        eps_r = cfg.ot_epsilon * anneal
        assoc, assoc_cert = assoc_mod.associate_primitives_ot(
            mbatch, atlas_view, scan_seq, cfg, z, shortlist, eps_r)
        L_lidar, h_lidar, vis_cert = evidence_pose.primitive_pose_evidence(
            assoc, mbatch, z, cfg, shortlist, cfg.pose_cauchy_r0_m * math.sqrt(anneal), view=atlas_view)
        if it + 1 < n_rounds:
            L6 = L_lidar[..., 0:6, 0:6] + cfg.eps_lift * linalg.eye(6, L_lidar)
            delta, _ = linalg.spd_solve_lifted(L6, h_lidar[..., 0:6], cfg.eps_lift)
            step_cap = 2.0 * math.sqrt(eps_r)
            nrm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
            delta = delta * torch.clamp(step_cap / (nrm + 1e-12), max=1.0)
            z = se3.se3_compose(z, se3.se3_exp(delta))

    # LiDAR translation residuals at the final linearization (third
    # measurement-noise IW block)
    R_zT = se3.so3_exp(z[..., 3:6]).transpose(-1, -2)
    meas_w = mean_positions(mbatch, cfg.eps_lift) @ R_zT + z[..., None, :3]
    map_pos = atlas_view.positions[assoc.cand_pool]
    pair_ok = (mbatch.valid[..., None] & atlas_view.valid[assoc.cand_pool]
               & (mbatch.sources == 1)[..., None])
    resid = torch.where(pair_ok[..., None], map_pos - meas_w[..., None, :], 0.0)
    resid = torch.where(torch.isfinite(resid), resid, 0.0)
    extras = MapExtras(
        batch=mbatch,
        responsibilities=assoc.responsibilities,
        cand_pool=assoc.cand_pool,
        row_masses=assoc.row_masses,
        ot_transport_mass=assoc.transport_mass,
        ot_marginal_defect_a=assoc.marginal_defect_a,
        z_map_pose=z,
        lidar_residuals=resid,
        lidar_resid_w=assoc.responsibilities * pair_ok.to(resid.dtype),
    )
    return L_lidar, h_lidar, [surf_cert, assoc_cert, vis_cert], extras


def hypothesis_extras(extras: MapExtras, k: int) -> MapExtras:
    """Hypothesis k's slice of per-hypothesis MapExtras."""
    return MapExtras(*[MeasurementBatch(*[x[k] for x in v]) if isinstance(v, MeasurementBatch) else v[k]
                       for v in extras])


# ---------------------------------------------------------------------------
# Map update (step 15: fuse / insert / cull / forget / merge) — hypothesis 0
# ---------------------------------------------------------------------------


def _transform_to_world(Lam_b, th_b, eta_b, R, t, eps_lift):
    """Gaussian info form + vMF lobes, body -> world at pose (R, t)."""
    Lam_w = R @ Lam_b @ R.T
    mu_w = linalg.solve3x3(Lam_b, th_b, eps=eps_lift) @ R.T + t[None, :]
    return Lam_w, mv(Lam_w, mu_w), eta_b @ R.T, mu_w


class _Slab(NamedTuple):
    """The (A, M, ...) active-stencil slab of every per-slot atlas channel."""

    Lambdas: torch.Tensor
    thetas: torch.Tensor
    etas: torch.Tensor
    weights: torch.Tensor
    valid: torch.Tensor
    timestamps: torch.Tensor
    created: torch.Tensor
    last_supported: torch.Tensor
    last_update: torch.Tensor
    primitive_ids: torch.Tensor
    cam_mass: torch.Tensor
    lidar_mass: torch.Tensor
    rgb_accum: torch.Tensor
    rgb_denom: torch.Tensor
    rgb: torch.Tensor


def _gather_slab(atlas: AtlasState, active_slots, shard=None) -> _Slab:
    return _Slab(**_read_slots(atlas, _Slab._fields, active_slots, shard))


def _scatter_slab(atlas: AtlasState, active_slots, slab: _Slab, shard=None) -> AtlasState:
    def put(f):
        if shard is not None:
            return collectives.write_rows(getattr(atlas, f), active_slots, getattr(slab, f), shard)
        out = getattr(atlas, f).clone()
        out[active_slots] = getattr(slab, f)
        return out

    return atlas._replace(**{f: put(f) for f in _Slab._fields})


def _flat_set(x: torch.Tensor, fidx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """x (A, M, ...) with flat rows fidx (into A*M) set to val rows; rows
    with fidx == A*M drop."""
    A, M = x.shape[:2]
    flat = x.reshape((A * M,) + x.shape[2:])
    v = val.reshape((-1,) + x.shape[2:])
    return scatter_set(flat, fidx, v).reshape(x.shape)


def _fuse_slab(slab: _Slab, view: AtlasView, extras: MapExtras,
               Lam_w, th_w, eta_w, scan_seq, timestamp, cfg: PipelineConfig):
    """PoE scatter-add fuse of all (meas, candidate) pairs in one pass."""
    S, M = slab.weights.shape
    V = cfg.m_tile_view
    N, K = extras.responsibilities.shape
    pool = extras.cand_pool.reshape(-1)
    pair_valid = (extras.batch.valid[:, None] & view.valid[pool].reshape(N, K)).reshape(-1)
    resp = extras.responsibilities.reshape(-1).to(MAPF) * pair_valid.to(MAPF)
    flat = torch.where(pair_valid, (pool // V) * M + view.slot[pool], S * M)

    def rep(x):
        return torch.repeat_interleave(x, K, dim=0)

    b = extras.batch
    Lam_m = rep(Lam_w).to(MAPF)
    th_m = rep(th_w).to(MAPF)
    eta_m = rep(eta_w).to(MAPF)
    w_m = rep(b.weights).to(MAPF)
    col_m = rep(b.colors).to(MAPF)
    is_cam = rep(b.sources == 0).to(MAPF)
    is_lid = rep(b.sources == 1).to(MAPF)

    NB = C.VMF_N_LOBES * 3
    rw = resp * w_m
    rwc = rw * is_cam
    payload = torch.cat(
        [
            resp[:, None] * Lam_m.reshape(-1, 9),
            resp[:, None] * th_m,
            resp[:, None] * eta_m.reshape(-1, NB),
            rw[:, None],
            rwc[:, None],
            (rw * is_lid)[:, None],
            col_m * rwc[:, None],
            resp[:, None],
        ],
        dim=1,
    )
    acc = scatter_accumulate(flat, payload, S * M)

    def seg(o, w, shape):
        return acc[:, o:o + w].reshape(shape)

    cam_inc = seg(13 + NB, 1, (S, M))
    cam_slab = slab.cam_mass + cam_inc
    rgb_accum_slab = slab.rgb_accum + seg(15 + NB, 3, (S, M, 3))
    rgb_denom_slab = slab.rgb_denom + cam_inc
    updated = seg(18 + NB, 1, (S, M)) > 0.0
    seq32 = scan_seq.to(torch.int32)
    rgb_est = torch.clamp(
        rgb_accum_slab / torch.clamp(rgb_denom_slab[..., None], min=cfg.eps_mass), 0.0, 1.0)
    slab = slab._replace(
        Lambdas=slab.Lambdas + seg(0, 9, (S, M, 3, 3)),
        thetas=slab.thetas + seg(9, 3, (S, M, 3)),
        etas=slab.etas + seg(12, NB, (S, M, C.VMF_N_LOBES, 3)),
        weights=slab.weights + seg(12 + NB, 1, (S, M)),
        timestamps=torch.where(updated, timestamp.to(TIME_DTYPE), slab.timestamps),
        last_supported=torch.where(updated, seq32, slab.last_supported),
        last_update=torch.where(updated, seq32, slab.last_update),
        cam_mass=cam_slab,
        lidar_mass=slab.lidar_mass + seg(14 + NB, 1, (S, M)),
        rgb_accum=rgb_accum_slab,
        rgb_denom=rgb_denom_slab,
        rgb=torch.where((cam_slab > 0.0)[..., None], rgb_est, 0.5),
    )
    return slab, torch.sum(resp * w_m)


def _insert_slab(slab: _Slab, next_global_id, extras: MapExtras, mu_w,
                 Lam_w, th_w, eta_w, active_ids, scan_seq, timestamp, cfg: PipelineConfig):
    """Novelty-driven fixed-budget insert with lowest-retention eviction."""
    A, M = slab.weights.shape
    Kin = cfg.k_insert_tile
    b = extras.batch
    dev = slab.weights.device

    valid_f = b.valid.to(BELIEF_DTYPE)
    a = valid_f / torch.clamp(valid_f.sum(), min=cfg.eps_mass)
    novelty = torch.clamp(a - extras.row_masses, min=0.0)
    score = novelty * b.weights - (1.0 - valid_f) * 1e6

    # per active tile: top-Kin in-tile proposals (gate above the invalid band)
    meas_tile_ids = tiling.tile_ids_from_xyz(mu_w, cfg.h_tile)
    in_tile = meas_tile_ids[None, :] == active_ids[:, None]
    top_score, top_idx = topk_lowest_index(torch.where(in_tile, score[None, :], -1e30), Kin)
    do_insert = top_score > 0.0

    # eviction targets: Kin lowest-retention slots per tile (invalid first)
    dt = torch.clamp(scan_seq.to(torch.int32) - slab.last_supported, min=0)
    retention = slab.weights * torch.exp(-cfg.recency_decay_lambda * dt.to(MAPF))
    retention = torch.where(slab.valid, retention, -torch.inf)
    finite = torch.isfinite(retention)
    _, evict_slots = topk_lowest_index(torch.where(finite, -retention, 1e30), Kin)

    gi = top_idx.reshape(-1)
    ins_valid = do_insert.reshape(-1)
    Lam_i = Lam_w[gi].to(MAPF)
    th_i = th_w[gi].to(MAPF)
    eta_i = eta_w[gi].to(MAPF)
    w_i = ((novelty * b.weights)[gi] * ins_valid).to(MAPF)
    col_i = b.colors[gi].to(MAPF)
    cam_i = (b.sources[gi] == 0).to(MAPF)

    order_ids = (next_global_id + torch.cumsum(ins_valid.to(torch.int32), 0) - 1).to(torch.int32)
    new_ids = torch.where(ins_valid, order_ids, -1).to(torch.int32)
    n_inserted = ins_valid.to(torch.int32).sum().to(torch.int32)

    tile_row = torch.repeat_interleave(torch.arange(A, device=dev), Kin)
    flat = torch.where(ins_valid, tile_row * M + evict_slots.reshape(-1), A * M)
    ret_gather = torch.gather(torch.where(finite, retention, 0.0), 1, evict_slots).reshape(-1)
    evicted_mass = torch.sum(ret_gather * ins_valid.to(MAPF))

    has_cam = cam_i * (w_i > 0)
    rgb_new = torch.where((has_cam > 0)[:, None], torch.clamp(col_i, 0.0, 1.0), 0.5)

    NB = C.VMF_N_LOBES * 3
    pay32 = torch.cat(
        [
            Lam_i.reshape(-1, 9),
            th_i,
            eta_i.reshape(-1, NB),
            w_i[:, None],
            (w_i * cam_i)[:, None],
            (w_i * (1.0 - cam_i))[:, None],
            col_i * (w_i * cam_i)[:, None],
            rgb_new,
        ],
        dim=1,
    )
    n_rows = w_i.shape[0]
    ts = timestamp.to(TIME_DTYPE).expand(n_rows)
    pay64 = torch.stack([ts, ts, scan_seq.to(TIME_DTYPE).expand(n_rows), new_ids.to(TIME_DTYPE)], dim=1)
    acc32 = scatter_set(slab.weights.new_zeros(A * M, pay32.shape[1]), flat, pay32)
    acc64 = scatter_set(torch.zeros(A * M, 4, dtype=TIME_DTYPE, device=dev), flat, pay64)
    written = scatter_set(torch.zeros(A * M, dtype=torch.bool, device=dev), flat,
                          torch.ones(n_rows, dtype=torch.bool, device=dev)).reshape(A, M)

    def pick(old, o, w):
        new = acc32[:, o:o + w].reshape(old.shape)
        m = written.reshape((A, M) + (1,) * (old.dim() - 2))
        return torch.where(m, new.to(old.dtype), old)

    def pick64(old, col):
        return torch.where(written, acc64[:, col].reshape(A, M).to(old.dtype), old)

    slab = slab._replace(
        Lambdas=pick(slab.Lambdas, 0, 9),
        thetas=pick(slab.thetas, 9, 3),
        etas=pick(slab.etas, 12, NB),
        weights=pick(slab.weights, 12 + NB, 1),
        timestamps=pick64(slab.timestamps, 0),
        created=pick64(slab.created, 1),
        last_supported=pick64(slab.last_supported, 2),
        last_update=pick64(slab.last_update, 2),
        primitive_ids=pick64(slab.primitive_ids, 3),
        valid=slab.valid | written,
        cam_mass=pick(slab.cam_mass, 13 + NB, 1),
        lidar_mass=pick(slab.lidar_mass, 14 + NB, 1),
        rgb_accum=pick(slab.rgb_accum, 15 + NB, 3),
        rgb_denom=pick(slab.rgb_denom, 13 + NB, 1),
        rgb=pick(slab.rgb, 18 + NB, 3),
    )
    events = dict(
        ins_ids=new_ids,
        ins_tiles=torch.repeat_interleave(active_ids, Kin),
        ins_mu=mu_w[gi].to(MAPF) * ins_valid[:, None].to(MAPF),
        ins_w=w_i,
    )
    next_id = (next_global_id + n_inserted).to(torch.int32)
    return slab, next_id, w_i.sum(), evicted_mass, events


# Precision floor below which a primitive is informationless (culled).
LAMBDA_CULL_FLOOR = 1e-12


def _cull_forget_slab(slab: _Slab, cfg: PipelineConfig):
    """Cull below-threshold weights + precision-collapsed primitives, then
    continuous forgetting."""
    lam_max = torch.diagonal(slab.Lambdas, dim1=-2, dim2=-1).abs().amax(-1)
    below = slab.valid & ((slab.weights < cfg.cull_weight_threshold) | (lam_max < LAMBDA_CULL_FLOOR))
    mass_dropped = torch.sum(slab.weights * below.to(MAPF))
    n_culled = below.to(torch.int32).sum()
    slab = slab._replace(valid=slab.valid & ~below, weights=slab.weights * cfg.forgetting_factor)
    return slab, mass_dropped, n_culled


V_MERGE = 128  # merge-reduce candidate window per tile
KC_MERGE = 64  # nearest-by-mu pair shortlist per tile


def _merge_reduce_slab(slab: _Slab, cfg: PipelineConfig):
    """Bhattacharyya merge-reduce, <= k_merge_pairs per active tile: among
    the V_MERGE heaviest slots, the KC_MERGE mu-nearest pairs are scored;
    greedy disjoint selection below merge_threshold; merged moments are
    weight-matched, vMF lobes and provenance add, the loser is invalidated."""
    Kp = cfg.k_merge_pairs_tile
    A, M = slab.weights.shape
    f64 = BELIEF_DTYPE
    dev = slab.weights.device
    V = min(V_MERGE, M)
    KC = min(KC_MERGE, (V * (V - 1)) // 2)
    I3 = torch.eye(3, dtype=f64, device=dev)

    _, cand = topk_lowest_index(torch.where(slab.valid, slab.weights, -torch.inf), V)  # (A, V)
    Lam = take_rows(slab.Lambdas, cand).to(f64)
    th = take_rows(slab.thetas, cand).to(f64)
    ws = take_rows(slab.weights, cand).to(f64)
    vs = take_rows(slab.valid, cand)
    Sigs = linalg.inv3x3(Lam + C.EPS_LIFT * I3)
    mus = mv(Sigs, th)
    det = linalg.det3x3(Sigs)

    d2 = torch.sum((mus[:, :, None, :] - mus[:, None, :, :]) ** 2, dim=-1)  # (A, V, V)
    upper = torch.ones(V, V, dtype=torch.bool, device=dev).triu(diagonal=1)
    d2 = torch.where(vs[:, :, None] & vs[:, None, :] & upper, d2, torch.inf).reshape(A, V * V)
    _, pflat = topk_lowest_index(-d2, KC)  # (A, KC)
    pi, pj = pflat // V, pflat % V

    S = 0.5 * (take_rows(Sigs, pi) + take_rows(Sigs, pj))
    dmu = take_rows(mus, pi) - take_rows(mus, pj)
    quad = 0.125 * torch.sum(dmu * mv(linalg.inv3x3(S, eps=C.EPS_LIFT), dmu), dim=-1)
    logt = 0.5 * torch.log(linalg.det3x3(S) / torch.sqrt(
        torch.gather(det, 1, pi) * torch.gather(det, 1, pj) + 1e-24))
    pair_ok = torch.gather(vs, 1, pi) & torch.gather(vs, 1, pj) & torch.isfinite(torch.gather(d2, 1, pflat))
    dist = torch.where(pair_ok, quad + logt, torch.inf)

    # greedy disjoint selection: Kp masked argmins per tile
    sel_i, sel_j, n_sel = [], [], torch.zeros(A, dtype=torch.int32, device=dev)
    for _ in range(Kp):
        p = torch.argmin(dist, dim=1, keepdim=True)
        i = torch.gather(pi, 1, p)
        j = torch.gather(pj, 1, p)
        ok = torch.gather(dist, 1, p) < cfg.merge_threshold
        sel_i.append(torch.where(ok, i, -1))
        sel_j.append(torch.where(ok, j, -1))
        conflict = (pi == i) | (pi == j) | (pj == i) | (pj == j)
        dist = torch.where(ok & conflict, torch.inf, dist)
        n_sel = n_sel + ok[:, 0].to(torch.int32)
    sel_i = torch.cat(sel_i, dim=1)
    sel_j = torch.cat(sel_j, dim=1)

    ok = sel_i >= 0  # (A, Kp)
    ii = torch.clamp(sel_i, min=0)
    jj = torch.clamp(sel_j, min=0)
    w1, w2 = torch.gather(ws, 1, ii), torch.gather(ws, 1, jj)
    wsum = w1 + w2
    wsafe = torch.clamp(wsum, min=C.EPS_MASS)
    mu1, mu2 = take_rows(mus, ii), take_rows(mus, jj)
    S1, S2 = take_rows(Sigs, ii), take_rows(Sigs, jj)
    mu_m = (w1[..., None] * mu1 + w2[..., None] * mu2) / wsafe[..., None]
    d1 = mu1 - mu_m
    d2m = mu2 - mu_m

    def outer(d):
        return d[..., :, None] * d[..., None, :]

    S_m = (w1[..., None, None] * (S1 + outer(d1)) + w2[..., None, None] * (S2 + outer(d2m))) \
        / wsafe[..., None, None]
    Lam_m = linalg.inv3x3(S_m + C.EPS_PSD * I3)
    th_m = mv(Lam_m, mu_m)

    ci = torch.gather(cand, 1, ii)
    cj = torch.gather(cand, 1, jj)
    eta_i = take_rows(slab.etas, ci).to(f64)
    eta_j = take_rows(slab.etas, cj).to(f64)
    eta_m = (w1[..., None, None] * eta_i + w2[..., None, None] * eta_j) / wsafe[..., None, None]

    af = torch.arange(A, device=dev)[:, None]
    fi = torch.where(ok, af * M + ci, A * M).reshape(-1)
    fj = torch.where(ok, af * M + cj, A * M).reshape(-1)

    cam_i, cam_j = take_rows(slab.cam_mass, ci), take_rows(slab.cam_mass, cj)
    lid_i, lid_j = take_rows(slab.lidar_mass, ci), take_rows(slab.lidar_mass, cj)
    rga_i, rga_j = take_rows(slab.rgb_accum, ci), take_rows(slab.rgb_accum, cj)
    rgd_i, rgd_j = take_rows(slab.rgb_denom, ci), take_rows(slab.rgb_denom, cj)
    ls_i, ls_j = take_rows(slab.last_supported, ci), take_rows(slab.last_supported, cj)
    zero_k = torch.zeros_like(w1)
    rgb_m = torch.where(
        ((cam_i + cam_j) > 0)[..., None],
        torch.clamp((rga_i + rga_j) / torch.clamp((rgd_i + rgd_j)[..., None], min=C.EPS_MASS), 0.0, 1.0),
        0.5,
    )
    slab = slab._replace(
        Lambdas=_flat_set(slab.Lambdas, fi, Lam_m),
        thetas=_flat_set(slab.thetas, fi, th_m),
        etas=_flat_set(slab.etas, fi, eta_m),
        weights=_flat_set(_flat_set(slab.weights, fi, wsum), fj, zero_k),
        valid=_flat_set(slab.valid, fj, torch.zeros_like(ok)),
        cam_mass=_flat_set(_flat_set(slab.cam_mass, fi, cam_i + cam_j), fj, zero_k),
        lidar_mass=_flat_set(_flat_set(slab.lidar_mass, fi, lid_i + lid_j), fj, zero_k),
        rgb_accum=_flat_set(slab.rgb_accum, fi, rga_i + rga_j),
        rgb_denom=_flat_set(slab.rgb_denom, fi, rgd_i + rgd_j),
        rgb=_flat_set(slab.rgb, fi, rgb_m),
        last_supported=_flat_set(slab.last_supported, fi, torch.maximum(ls_i, ls_j)),
    )
    return slab, n_sel.sum().to(torch.int32)


def map_update_step(
    atlas: AtlasState,
    view: AtlasView,
    extras: MapExtras,
    z_t_pose: torch.Tensor,
    active_slots: torch.Tensor,
    active_ids: torch.Tensor,
    scan_seq: torch.Tensor,
    timestamp: torch.Tensor,
    cfg: PipelineConfig,
    shard=None,
):
    """Step-15 map update at z_t: one slab gather, fuse -> insert ->
    cull/forget -> merge (on the merge_every cadence, selected branch-free),
    one slab scatter."""
    R_t = se3.so3_exp(z_t_pose[3:6])
    b = extras.batch
    Lam_w, th_w, eta_w, mu_w = _transform_to_world(b.Lambdas, b.thetas, b.etas, R_t, z_t_pose[:3],
                                                   cfg.eps_lift)
    slab = _gather_slab(atlas, active_slots, shard)
    slab, fused_mass = _fuse_slab(slab, view, extras, Lam_w, th_w, eta_w, scan_seq, timestamp, cfg)
    slab, next_id, insert_mass, evicted_mass, ins_events = _insert_slab(
        slab, atlas.next_global_id, extras, mu_w, Lam_w, th_w, eta_w,
        active_ids, scan_seq, timestamp, cfg)
    slab, cull_mass, n_culled = _cull_forget_slab(slab, cfg)
    if cfg.k_merge_pairs_tile <= 0:
        n_merged = torch.zeros((), dtype=torch.int32, device=n_culled.device)
    else:
        merged, n_merged = _merge_reduce_slab(slab, cfg)
        if cfg.merge_every > 1:
            on = scan_seq.to(torch.int32) % cfg.merge_every == cfg.merge_every - 1
            slab = _Slab(*[torch.where(on, m, s) for m, s in zip(merged, slab)])
            n_merged = torch.where(on, n_merged, 0)
        else:
            slab = merged
    atlas = _scatter_slab(atlas, active_slots, slab, shard)._replace(next_global_id=next_id)

    f = BELIEF_DTYPE
    tape = dict(
        fused_mass=fused_mass.to(f),
        insert_mass=insert_mass.to(f),
        evicted_mass=(evicted_mass + cull_mass).to(f),
        n_culled=n_culled.to(f),
        n_merged=n_merged.to(f),
        valid_total=atlas.valid.to(f).sum() if shard is None else collectives.sum_over(atlas.valid.to(f).sum(), shard),
        ot_transport_mass=extras.ot_transport_mass.to(f),
        ot_marginal_defect_a=extras.ot_marginal_defect_a.to(f),
        **ins_events,
    )
    return atlas, tape
