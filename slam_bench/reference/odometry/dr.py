"""Dead reckoning at the DVL ticks, as ``pipeline.odometry`` runs it for
``frontend="dr"``."""

from ..estimators import dead_reckoning_scan, dead_reckoning_with_basis_scan
from ..stages import dr_bundle


def odometry(bag, dims, dr_config, dev):
    """(tick times, poses3 (T, 6), basis (T, 2, 2) or None): the basis
    integrals where the scan aggregates with them or estimates the DVL
    scale from them."""
    bundle = dr_bundle(bag, dev)
    if ((dims.refine_scale_basis and dims.estimate_dvl_scale)
            or dims.aggregate_with_dr_basis):
        poses, basis = dead_reckoning_with_basis_scan(bundle.ticks, dr_config)
        return bundle.tick_time, poses, basis
    return bundle.tick_time, dead_reckoning_scan(bundle.ticks, dr_config), None
