"""Masked fixed-capacity point-cloud ops: nearest neighbours, radius
filtering, voxel downsampling, normals and batched ICP."""

from .filters import remove_outlier
from .icp import (
    ICPConfig,
    ICPResult,
    censi_covariance,
    icp,
    icp_multistart,
    icp_pairs,
)
from .knn import count_overlap, nn_match, pairwise_sq_dists
from .normals import estimate_normals
from .voxel import (
    VoxelGridSpec,
    top_k_stable,
    voxel_downsample,
    voxel_downsample_with_conf,
)
