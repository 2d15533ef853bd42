from .dataset import SensorStreams, build_dr_ticks, match_pings_to_ticks
