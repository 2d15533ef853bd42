"""Log-odds occupancy mapping and map metrics."""

from .metrics import map_metrics, observed_mask, occupied_cell_centers
from .occupancy import (
    MappingConfig,
    MappingState,
    SubmapModel,
    add_keyframe,
    build_submap_logodds,
    get_occupancy_map,
    grow,
    intensity_grid,
    mapping_init,
    occupancy_grid_method1,
    occupancy_grid_method2,
    render_global_logodds,
    resample_grid,
    save_submaps,
    submap_intensity,
    update_poses,
)
