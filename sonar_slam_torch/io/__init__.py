"""Host-side data: stream alignment and the synthetic bag simulator."""

from .dataset import (
    DRTickBundle,
    SensorStreams,
    build_dr_ticks,
    match_pings_to_ticks,
)
from .simulate import SimConfig, SyntheticBag, simulate_bag
