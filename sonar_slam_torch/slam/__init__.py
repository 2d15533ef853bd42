"""Sonar geometry, feature front end, scan matching and the SLAM core."""

from .core import (
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
from .sonar import SonarGeometry
