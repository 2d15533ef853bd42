"""Sonar geometry, feature front end, scan matching, the SLAM core and loop
refinement."""

from .core import (
    STATUS_INITIALIZATION_FAILURE,
    STATUS_LARGE_TRANSFORMATION,
    STATUS_NAMES,
    STATUS_NOT_CONVERGED,
    STATUS_NOT_ENOUGH_OVERLAP,
    STATUS_NOT_ENOUGH_POINTS,
    STATUS_SUCCESS,
    KeyframeInput,
    SlamCarry,
    SlamDims,
    SlamParams,
    StepOutputs,
    keyframe_step,
    select_keyframes,
    slam_init,
    slam_scan,
)
from .frontend import FeatureConfig, FeatureExtractor, corroborate, corroboration_gate
from .refine import RefineParams, refine_loops
from .scan_matching import (
    GlobalInitResult,
    apply_covariance_floor,
    estimate_pose_covariance,
    global_initialize,
    localize_covariance,
    match_count_costs,
    sobol_unit_samples,
)
from .sonar import (
    SonarGeometry,
    adjust_gamma,
    decompress_gamma,
    points_in_fov,
    remap_polar_to_cart,
    wiener_deconvolve,
)
