"""Utilities: span timing and profiling, logging, the stream registry and
visualization (``utils.viz``, matplotlib imported when called)."""

from .timing import (
    CodeTimer,
    reset_timing,
    set_timing_enabled,
    timing_report,
    torch_profile_trace,
)
from .logging import loginfo, logwarn, logerror, logdebug, set_log_level
from .streams import Streams
from .profile import profile_slam_components
