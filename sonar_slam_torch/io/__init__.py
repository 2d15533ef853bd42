"""Host-side data: stream alignment and the synthetic bag simulator. The
submodules ``config`` (the YAML loaders), ``state`` (state export and
checkpoints), ``rosbag`` and ``lz4`` (the ROS bag reader) are imported by
name."""

from .dataset import (
    DRTickBundle,
    SensorStreams,
    build_dr_ticks,
    match_pings_to_ticks,
)
from .simulate import SimConfig, SyntheticBag, simulate_bag
