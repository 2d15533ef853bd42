"""SE(2) factor-graph Gauss-Newton smoother and PCM loop vetting."""

from .factor_graph import (
    GraphConfig,
    GraphState,
    add_between,
    add_prior,
    cov_to_sqrt_info,
    graph_init,
    marginal_covariance,
    optimize,
    optimize_with_marginal,
    set_pose_estimate,
    sigmas_to_sqrt_info,
)
from .pcm import (
    CHI2_99_3DOF,
    max_clique_mask,
    pairwise_consistency_matrix,
    pcm_select,
)
