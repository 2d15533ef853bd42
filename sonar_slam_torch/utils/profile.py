"""Component timing under the reference's span names.

Counterpart of ``sonar_slam_tpu/utils/profile.py``. The reference times four
blocks of its SLAM node with ``CodeTimer``:

    "SLAM - sequential scan matching - sampling"
    "SLAM - sequential scan matching - ICP"
    "SLAM - nonsequential scan matching - sampling"
    "SLAM - nonsequential scan matching - ICP"

The port's scan runs them inside ``keyframe_step``; this module times the
same four computations alone, on synthetic clouds at the configured
capacities and with the port's ``global_initialize``, ``icp`` and
``icp_multistart``, so the numbers stay comparable with the reference's
logs. Each span ends in a device sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import icp, icp_multistart
from ..slam.scan_matching import global_initialize
from .timing import CodeTimer


def profile_slam_components(dims, params, device, repeats: int = 3) -> dict:
    """Time the four reference spans at ``dims``' capacities on ``device``
    (``params`` a SlamParams on that device). Returns {span name: seconds},
    the median of ``repeats`` warm runs."""
    rng = np.random.default_rng(0)
    N, M = dims.max_points, dims.target_capacity

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    src = t(rng.uniform(0, 20, (N, 2)))
    smask = torch.ones(N, dtype=torch.bool, device=device)
    tgt = t(rng.uniform(0, 20, (M, 2)))
    tmask = torch.ones(M, dtype=torch.bool, device=device)
    zero = torch.zeros(3, device=device)
    src_big = t(rng.uniform(0, 20, (M, 2)))
    sbig_mask = torch.ones(M, dtype=torch.bool, device=device)
    guesses = t(rng.normal(scale=0.2, size=(max(dims.nssm_cov_samples, 1), 3)))
    gmask = torch.ones(guesses.shape[0], dtype=torch.bool, device=device)

    def ssm_sampling():
        return global_initialize(
            src, smask, tgt, tmask, zero, zero, 5.0 * params.odom_sigmas,
            params.ssm_sobol_pts, params.point_noise,
            max(dims.ssm_cov_samples, 1)).best_delta

    def ssm_icp():
        return icp(src, smask, tgt, tmask, zero, dims.icp).pose

    def nssm_sampling():
        return global_initialize(
            src_big, sbig_mask, tgt, tmask, zero, zero,
            t([2.0, 2.0, 0.5]), params.nssm_sobol_pts, params.point_noise,
            max(dims.nssm_cov_samples, 1)).best_delta

    def nssm_icp():
        return icp_multistart(src_big, sbig_mask, tgt, tmask, guesses, gmask,
                              dims.icp).pose

    spans = {
        "SLAM - sequential scan matching - sampling": ssm_sampling,
        "SLAM - sequential scan matching - ICP": ssm_icp,
        "SLAM - nonsequential scan matching - sampling": nssm_sampling,
        "SLAM - nonsequential scan matching - ICP": nssm_icp,
    }
    out = {}
    for name, fn in spans.items():
        with CodeTimer(name, silent=True, sync=device):  # warm-up
            fn()
        times = []
        for _ in range(repeats):
            with CodeTimer(name, silent=True, sync=device) as span:
                fn()
            times.append(span.took)
        out[name] = float(np.median(times))
    return out
