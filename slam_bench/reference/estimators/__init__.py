from .dead_reckoning import (
    DRConfig,
    DRState,
    DRTicks,
    dead_reckoning_init,
    dead_reckoning_scan,
    dead_reckoning_step,
    dead_reckoning_with_basis_scan,
)
