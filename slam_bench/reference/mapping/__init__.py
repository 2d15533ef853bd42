from .occupancy import (
    MappingConfig,
    SubmapModel,
    build_submap_logodds,
    mapping_init,
    occupancy_grid_method1,
    render_global_logodds,
)
