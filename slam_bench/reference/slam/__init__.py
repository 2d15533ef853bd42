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
from .frontend import FeatureConfig, FeatureExtractor, corroborate
from .refine import RefineParams, refine_loops
from .sonar import SonarGeometry
