"""Log-odds occupancy mapping and map metrics."""

from .metrics import map_metrics, observed_mask, occupied_cell_centers
from .occupancy import (
    MappingConfig,
    MappingState,
    SubmapModel,
    build_submap_logodds,
    mapping_init,
    occupancy_grid_method1,
    render_global_logodds,
)
