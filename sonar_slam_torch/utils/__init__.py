"""Utilities: spans and host-read counters, logging, the stream registry and
visualization (``utils.viz``, matplotlib imported when called)."""

from .timing import (
    CodeTimer,
    host_read,
    reset_timing,
    set_timing_enabled,
    timing_report,
    trace_records,
)
from .logging import loginfo, logwarn, logerror, logdebug, set_log_level
from .streams import Streams
