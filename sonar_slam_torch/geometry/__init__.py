"""SE(2) pose algebra and the pose3 helpers, on torch tensors."""

from .se2 import (
    se2_between,
    se2_compose,
    se2_expmap,
    se2_from_matrix,
    se2_inverse,
    se2_local_coordinates,
    se2_logmap,
    se2_matrix,
    se2_retract,
    se2_rotmat,
    se2_transform_points,
    wrap_angle,
)
from .se3 import (
    pose2_to_pose3,
    pose3_between,
    pose3_compose,
    pose3_inverse,
    pose3_make,
    pose3_rotmat,
    pose3_to_pose2,
    pose3_transform_points,
    rot3_compose,
    rot3_inverse,
    rot3_to_ypr,
    rot3_ypr,
)
