"""SE(2) pose algebra and the pose3 helpers the stages use, on torch tensors."""

from .se2 import (
    se2_between,
    se2_compose,
    se2_expmap,
    se2_inverse,
    se2_logmap,
    se2_retract,
    se2_rotmat,
    se2_transform_points,
    wrap_angle,
)
from .se3 import pose3_make, pose3_to_pose2
