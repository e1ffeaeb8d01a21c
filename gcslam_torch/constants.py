"""GC v2 manifest constants — budgets, epsilons, slices, noise priors
(value-for-value copy of the JAX package's constants.py; the port may not import
the JAX package, which pulls in JAX).

State vector (22D tangent), ordering GC-RIGHT-01:
    [trans(0:3), rot(3:6), vel(6:9), bg(9:12), ba(12:15), dt(15:16), ex(16:22)]
"""

# ---------------------------------------------------------------------------
# Chart / dimensions
# ---------------------------------------------------------------------------
CHART_ID = "GC-RIGHT-01"
D_Z = 22
D_DESKEW = 22

# ---------------------------------------------------------------------------
# Fixed-cost budgets (compile-time constants; reference constants.py:62-67)
#
# GCSLAM_K_HYP / GCSLAM_K_SINKHORN env overrides are the rebuild path of
# the measurement tools: tools/attribute_step measures its hyp_* and
# sinkhorn_* variants in child processes started with them (as
# tools/precision_compare does for the dtype), as the JAX package's does.
# The production fail-fast still binds config values to whatever this
# module was imported with, so a mismatched config cannot start.
# ---------------------------------------------------------------------------
import os as _os

K_HYP = int(_os.environ.get("GCSLAM_K_HYP", "4"))
if not 1 <= K_HYP <= 4:
    raise ValueError(f"GCSLAM_K_HYP must be in [1, 4], got {K_HYP}")
HYP_WEIGHT_FLOOR = 0.01 / K_HYP  # 0.0025 at the production K_HYP=4
# Hypothesis diversification (TPU-first redesign of the reference's K_HYP=4
# bit-identical copies, backend_node.py:823): each hypothesis runs a distinct
# evidence-trust profile — (power-beta scale, map-evidence scale) — and the
# weights update every scan from the evidence fit, so the barycenter favors
# whichever trust setting the data currently supports.
HYP_BETA_SCALE = (1.0, 0.7, 1.0, 0.7)[:K_HYP]
HYP_MAP_EVIDENCE_SCALE = (1.0, 1.0, 0.6, 0.6)[:K_HYP]
HYP_WEIGHT_LL_GAIN = 0.1  # per-scan weight-update temperature on nll_per_ess
N_POINTS_CAP = 8192
MAX_IMU_PREINT_LEN = 512

# ---------------------------------------------------------------------------
# Epsilons (reference constants.py:70-75)
# ---------------------------------------------------------------------------
EPS_PSD = 1e-12
EPS_LIFT = 1e-9
EPS_MASS = 1e-12
EPS_R = 1e-6
EPS_DEN = 1e-12
EXC_EPS = 1e-12

# ---------------------------------------------------------------------------
# World / IMU conventions (reference constants.py:77-111)
# ---------------------------------------------------------------------------
GRAVITY_W = (0.0, 0.0, -9.81)  # Z-UP world; gravity points down.
GRAVITY_MAG = 9.81
IMU_ACCEL_SCALE = 9.81  # g -> m/s^2 for sensors reporting g's.

ALPHA_MIN = 1.0
ALPHA_MAX = 1.0
KAPPA_SCALE = 1.0
C0_COND = 1e6

KAPPA_BLEND_R0 = 0.8
KAPPA_BLEND_TAU = 0.03

C_DT = 1.0
C_EX = 1.0
C_FROB = 1.0

ANCHOR_DRIFT_M0 = 0.5  # m
ANCHOR_DRIFT_R0 = 0.2  # rad

INIT_ANCHOR_GYRO_SCALE = 0.5
INIT_ANCHOR_ACCEL_SCALE = 2.0

# ---------------------------------------------------------------------------
# State slices (reference constants.py:113-138)
# ---------------------------------------------------------------------------
IDX_TRANS = slice(0, 3)
IDX_ROT = slice(3, 6)
IDX_VEL = slice(6, 9)
IDX_BG = slice(9, 12)
IDX_BA = slice(12, 15)
IDX_DT = 15
IDX_DT_SLICE = slice(15, 16)
IDX_EX = slice(16, 22)
IDX_POSE = slice(0, 6)

TIME_WARP_SIGMA_FRAC = 0.1

# ---------------------------------------------------------------------------
# Inverse-Wishart adaptive noise (reference constants.py:149-281)
# ---------------------------------------------------------------------------
IW_NU_WEAK_ADD = 0.5

IMU_GYRO_NOISE_DENSITY = 8.7e-7   # rad^2/s (continuous-time PSD)
IMU_ACCEL_NOISE_DENSITY = 9.5e-5  # m^2/s^3 (continuous-time PSD)
LIDAR_SIGMA_MEAS = 0.01           # m^2 (discrete covariance scale)

PROCESS_ROT_DIFFUSION = IMU_GYRO_NOISE_DENSITY
PROCESS_TRANS_DIFFUSION = 1e-4
PROCESS_VEL_DIFFUSION = IMU_ACCEL_NOISE_DENSITY
PROCESS_BG_DIFFUSION = 1e-8
PROCESS_BA_DIFFUSION = 1e-6
PROCESS_DT_DIFFUSION = 1e-6
PROCESS_EXTRINSIC_DIFFUSION = 1e-8
PROCESS_Z_DIFFUSION = 1e-8

OU_DAMPING_LAMBDA = 0.1  # 1/s

WEIGHT_FLOOR = 1e-12
NONFINITE_SENTINEL = 1e6

RANGE_WEIGHT_SIGMA = 0.25
RANGE_WEIGHT_MIN_R = 0.5
RANGE_WEIGHT_MAX_R = 50.0

# IW retention per scan (process blocks: trans, rot, vel, bg, ba, dt, ex)
IW_RHO_TRANS = 0.99
IW_RHO_ROT = 0.995
IW_RHO_VEL = 0.95
IW_RHO_BG = 0.999
IW_RHO_BA = 0.999
IW_RHO_DT = 0.9999
IW_RHO_EX = 0.9999

IW_RHO_MEAS_GYRO = 0.995
IW_RHO_MEAS_ACCEL = 0.995
IW_RHO_MEAS_LIDAR = 0.99

IW_NU_MAX = 1000.0

# ---------------------------------------------------------------------------
# Planar robot priors (reference constants.py:283-314)
# ---------------------------------------------------------------------------
PLANAR_Z_REF = 0.0
ODOM_Z_VARIANCE_PRIOR = 1e6
PLANAR_Z_SIGMA = 0.1
PLANAR_VZ_SIGMA = 0.01

ODOM_TWIST_VEL_SIGMA = 0.1
ODOM_TWIST_WZ_SIGMA = 0.01

# ---------------------------------------------------------------------------
# Primitive map / OT budgets (reference constants.py:334-477)
# ---------------------------------------------------------------------------
N_FEAT = 512
N_SURFEL = 1024
K_ASSOC = 8
# GCSLAM_K_SINKHORN: sanctioned measurement-tool override (see K_HYP note).
K_SINKHORN = int(_os.environ.get("GCSLAM_K_SINKHORN", "50"))
RINGBUF_LEN = 5

OT_EPSILON = 0.02  # sharper than the reference's 0.1: ~0.15 m association scale
OT_TAU_A = 0.5
OT_TAU_B = 0.5
OT_COST_BETA = 0.5

POSE_EVIDENCE_BACKEND = "primitives"
MAP_BACKEND = "primitive_map"

# Atlas tiling (reference constants.py:394-450).
H_TILE = 2.0
R_ACTIVE_TILES_XY = 1
R_ACTIVE_TILES_Z = 0
R_STENCIL_TILES_XY = 1
R_STENCIL_TILES_Z = 0

RECENCY_DECAY_LAMBDA = 0.02
RECENCY_MIN_SCALE = 0.05


def hex_disk_count_xy(r: int) -> int:
    """Number of hex cells in a radius-r axial hex disk: 1 + 3r(r+1)."""
    rr = max(int(r), 0)
    return 1 + 3 * rr * (rr + 1)


N_ACTIVE_TILES = (2 * R_ACTIVE_TILES_Z + 1) * hex_disk_count_xy(R_ACTIVE_TILES_XY)
N_STENCIL_TILES = (2 * R_STENCIL_TILES_Z + 1) * hex_disk_count_xy(R_STENCIL_TILES_XY)

M_TILE_VIEW = 1024

# Device-resident atlas capacities (TPU design; the reference used a Python
# dict of 50_000-slot tiles, fl_slam_poc/backend/structures/primitive_map.py:182-227.
# Here the atlas is a fixed (MAX_TILES, M_TILE) HBM-resident SoA).
ATLAS_MAX_TILES = 128
M_TILE = 2048

PRIMITIVE_FORGETTING_FACTOR = 0.995
PRIMITIVE_MERGE_THRESHOLD = 0.1
K_MERGE_PAIRS_PER_TILE = 4
PRIMITIVE_MERGE_MAX_TILE_SIZE = 2048
PRIMITIVE_CULL_WEIGHT_THRESHOLD = 1e-4
PRIMITIVE_KAPPA_MIN = 1e-3
PRIMITIVE_KAPPA_MAX = 1e4

VMF_N_LOBES = 3

FUSE_CHUNK_SIZE = 1024
ASSOC_BLOCK_SIZE = 256
K_INSERT = 64
K_INSERT_TILE = K_INSERT

# Camera defaults (reference constants.py:479-488)
DEFAULT_CAMERA_K = (500.0, 500.0, 320.0, 240.0)
DEFAULT_T_BASE_CAMERA = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

# Power tempering defaults (reference backend/pipeline.py:117-121)
POWER_BETA_MIN = 0.25
POWER_BETA_EXC_C = 50.0
POWER_BETA_Z_C = 1.0
