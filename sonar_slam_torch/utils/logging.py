"""Colored logging shims (the rospy/tqdm logging of `utils/io.py:36-105`,
without ROS): plain stderr with ANSI severity colors and a global level."""

from __future__ import annotations

import sys
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_LEVEL = _LEVELS["info"]
_COLORS = {"debug": "\033[36m", "info": "\033[32m", "warn": "\033[33m",
           "error": "\033[31m"}
_RESET = "\033[0m"


def set_log_level(level: str) -> None:
    global _LEVEL
    _LEVEL = _LEVELS[level]


def _emit(level: str, msg: str) -> None:
    if _LEVELS[level] < _LEVEL:
        return
    ts = time.strftime("%H:%M:%S")
    color = _COLORS[level] if sys.stderr.isatty() else ""
    reset = _RESET if sys.stderr.isatty() else ""
    print(f"{color}[{level.upper():5s} {ts}] {msg}{reset}", file=sys.stderr)


def logdebug(msg: str) -> None:
    _emit("debug", msg)


def loginfo(msg: str) -> None:
    _emit("info", msg)


def logwarn(msg: str) -> None:
    _emit("warn", msg)


def logerror(msg: str) -> None:
    _emit("error", msg)
