"""Pipeline configuration (counterpart of the JAX package's models/config.py).

A frozen dataclass with the same fields, defaults, ranges and validate()
as the JAX package, except three backend selectors that have no meaning
here: `sinkhorn_backend` (the port always runs its CUDA kernel on CUDA
tensors and the plain loop on CPU tensors), `shortlist_recall` and
`select_recall` (the port's top-k selections are always exact, which is
what the JAX package computes on CPU). Budgets must match the constants.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference.plain import constants as C


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # Budgets (hard constants)
    k_hyp: int = C.K_HYP
    n_points_cap: int = C.N_POINTS_CAP
    n_feat: int = C.N_FEAT
    n_surfel: int = C.N_SURFEL
    max_imu_len: int = C.MAX_IMU_PREINT_LEN
    k_assoc: int = C.K_ASSOC
    k_sinkhorn: int = C.K_SINKHORN

    # Epsilons
    eps_psd: float = C.EPS_PSD
    eps_lift: float = C.EPS_LIFT
    eps_mass: float = C.EPS_MASS

    # Fusion / tempering
    alpha_min: float = C.ALPHA_MIN
    alpha_max: float = C.ALPHA_MAX
    kappa_scale: float = C.KAPPA_SCALE
    c0_cond: float = C.C0_COND
    power_beta_min: float = C.POWER_BETA_MIN
    power_beta_exc_c: float = C.POWER_BETA_EXC_C
    power_beta_z_c: float = C.POWER_BETA_Z_C
    c_dt: float = C.C_DT
    c_ex: float = C.C_EX
    c_frob: float = C.C_FROB

    # IMU ("predict" is the flagship filter; "evidence" adds the gyro and
    # preintegration factors to a diffusion prediction)
    imu_gravity_scale: float = 1.0
    deskew_rotation_only: bool = False
    imu_mode: str = "predict"

    # Planar priors / odometry ("relative": the odometry factor targets
    # pose0 o odom_rel_pose)
    enable_planar_prior: bool = True
    planar_z_ref: float = C.PLANAR_Z_REF
    planar_z_sigma: float = C.PLANAR_Z_SIGMA
    planar_vz_sigma: float = C.PLANAR_VZ_SIGMA
    enable_odom_twist: bool = True
    odom_pose_mode: str = "absolute"

    # Map / atlas budgets
    with_map: bool = True
    atlas_max_tiles: int = C.ATLAS_MAX_TILES
    m_tile: int = C.M_TILE
    m_tile_view: int = C.M_TILE_VIEW
    h_tile: float = C.H_TILE
    n_active_tiles: int = C.N_ACTIVE_TILES
    n_stencil_tiles: int = C.N_STENCIL_TILES
    r_active_xy: int = C.R_ACTIVE_TILES_XY
    r_active_z: int = C.R_ACTIVE_TILES_Z
    r_stencil_xy: int = C.R_STENCIL_TILES_XY
    r_stencil_z: int = C.R_STENCIL_TILES_Z
    recency_decay_lambda: float = C.RECENCY_DECAY_LAMBDA
    recency_min_scale: float = C.RECENCY_MIN_SCALE
    k_insert_tile: int = C.K_INSERT_TILE
    k_merge_pairs_tile: int = C.K_MERGE_PAIRS_PER_TILE
    # Merge-reduce runs on every merge_every-th scan (budgeting approximation).
    merge_every: int = 2
    merge_threshold: float = C.PRIMITIVE_MERGE_THRESHOLD
    cull_weight_threshold: float = C.PRIMITIVE_CULL_WEIGHT_THRESHOLD
    forgetting_factor: float = C.PRIMITIVE_FORGETTING_FACTOR

    # OT association
    ot_epsilon: float = C.OT_EPSILON
    ot_tau_a: float = C.OT_TAU_A
    ot_tau_b: float = C.OT_TAU_B
    ot_cost_beta: float = C.OT_COST_BETA
    ot_subtract_row_min: bool = False
    # Distance shortlist per measurement (0 = associate against the full pool).
    k_shortlist: int = 32
    shortlist_margin_m: float = 1.0
    # Shared surfel extraction and one shared GN chain across hypotheses;
    # both False is the reference's per-hypothesis map branch.
    map_share_extraction: bool = True
    map_gn_shared: bool = True

    # Surfel extraction
    surfel_voxel_size_m: float = 0.1
    surfel_min_points_per_voxel: int = 3
    pose_point_to_plane: bool = True
    map_evidence_scale: float = 1.0
    map_icp_iters: int = 2
    map_icp_coarse_factor: float = 8.0
    pose_sigma_floor_m: float = 0.01
    pose_cauchy_r0_m: float = 0.05
    pose_scan_sigma_floor_m: float = 0.02
    pose_scan_sigma_floor_rad: float = 0.002

    # Camera: with_camera adds the batch's camera rows to the measurement
    # batch. pose_rot_scatter_surfels_only keeps camera splats (whose vMF
    # lobe is the viewpoint-dependent viewing ray) out of the rotation
    # scatter; pose_camera_weight scales camera rows' responsibilities in
    # the pose factor; pose_modality_mode "cam_to_lidar" lets camera rows
    # vote only against lidar-dominant slots ("matched": same-modality pairs).
    with_camera: bool = False
    pose_rot_scatter_surfels_only: bool = True
    pose_camera_weight: float = 1.0
    pose_modality_matched: bool = True
    pose_modality_mode: str = "cam_to_lidar"

    hyp_diversify: bool = True

    def validate(self) -> None:
        """Budgets must match the constants, numerics must lie in their
        declared ranges and enums must be known values (same contract as the
        JAX package's validate())."""
        hard = {
            "k_hyp": C.K_HYP,
            "n_points_cap": C.N_POINTS_CAP,
            "max_imu_len": C.MAX_IMU_PREINT_LEN,
            "k_assoc": C.K_ASSOC,
            "k_sinkhorn": C.K_SINKHORN,
        }
        for name, expected in hard.items():
            got = getattr(self, name)
            if got != expected:
                raise ValueError(
                    f"PipelineConfig.{name}={got} does not match compiled constant {expected}; "
                    "budgets are compile-time constants (no silent overrides)."
                )
        for name, lo, hi in PARAM_RANGES:
            v = getattr(self, name)
            if not (lo <= v <= hi):
                raise ValueError(
                    f"PipelineConfig.{name}={v} outside declared range [{lo}, {hi}]"
                )
        for name, allowed in PARAM_ENUMS:
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(f"PipelineConfig.{name}={v!r} not in {allowed}")
        if self.m_tile_view > self.m_tile:
            raise ValueError("m_tile_view must be <= m_tile")
        if 0 < self.k_shortlist < self.k_assoc:
            raise ValueError("k_shortlist must be 0 (off) or >= k_assoc")
        if self.map_gn_shared and not self.map_share_extraction:
            raise ValueError("map_gn_shared requires map_share_extraction")

    def check_ported(self) -> None:
        """Every option of this config has its code path in the port, so
        nothing is refused; the entry points call this before they run."""


PARAM_RANGES = [
    ("eps_psd", 0.0, 1.0),
    ("eps_lift", 0.0, 1.0),
    ("eps_mass", 0.0, 1.0),
    ("alpha_min", 0.0, 1.0),
    ("alpha_max", 0.0, 1.0),
    ("kappa_scale", 0.0, 1e6),
    ("power_beta_min", 0.0, 1.0),
    ("imu_gravity_scale", 0.0, 2.0),
    ("planar_z_sigma", 1e-6, 1e3),
    ("planar_vz_sigma", 1e-6, 1e3),
    ("atlas_max_tiles", 1, 65536),
    ("m_tile", 1, 65536),
    ("m_tile_view", 1, 65536),
    ("h_tile", 1e-3, 1e3),
    ("recency_decay_lambda", 0.0, 10.0),
    ("recency_min_scale", 0.0, 1.0),
    ("k_insert_tile", 1, 4096),
    ("merge_threshold", 0.0, 1e6),
    ("merge_every", 1, 64),
    ("cull_weight_threshold", 0.0, 1e6),
    ("forgetting_factor", 0.0, 1.0),
    ("ot_epsilon", 1e-6, 1e3),
    ("ot_tau_a", 0.0, 1e6),
    ("ot_tau_b", 0.0, 1e6),
    ("ot_cost_beta", 0.0, 1e6),
    ("k_shortlist", 0, 65536),
    ("shortlist_margin_m", 0.0, 100.0),
    ("surfel_voxel_size_m", 1e-3, 10.0),
    ("surfel_min_points_per_voxel", 1, 1024),
    ("map_evidence_scale", 0.0, 1e3),
    ("map_icp_iters", 1, 8),
    ("map_icp_coarse_factor", 1.0, 64.0),
    ("pose_sigma_floor_m", 1e-6, 1.0),
    ("pose_cauchy_r0_m", 1e-4, 10.0),
    ("pose_scan_sigma_floor_m", 1e-6, 1.0),
    ("pose_scan_sigma_floor_rad", 1e-6, 1.0),
    ("pose_camera_weight", 0.0, 1e3),
]

PARAM_ENUMS = [
    ("imu_mode", ("predict", "evidence")),
    ("odom_pose_mode", ("absolute", "relative")),
    ("pose_modality_mode", ("cam_to_lidar", "matched")),
]


def read_config_mapping(path: str) -> dict:
    """A run-config file as a mapping: JSON, else YAML."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


def config_from_file(path: str, **overrides) -> PipelineConfig:
    """A PipelineConfig from a YAML or JSON file (the single-config contract
    of the reference's config/gc_unified.yaml). Unknown keys are an error,
    keyword arguments override the file's values, and the result is
    validate()d. The `frontend:` section (rosbag.bag_config_from_file) and
    the `eval:` section are read by their own loaders."""
    data = read_config_mapping(path)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a mapping at top level, got {type(data)}")
    data.pop("frontend", None)
    data.pop("eval", None)
    known = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(f"{path}: unknown PipelineConfig keys: {unknown}")
    data.update(overrides)
    cfg = PipelineConfig(**data)
    cfg.validate()
    return cfg
