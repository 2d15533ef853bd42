"""The YAML configuration files, read into the port's types.

Counterpart of ``sonar_slam_tpu/io/config.py``: the same seven files (copied
into ``sonar_slam_torch/config/``), the same rosparam substitutions
(``deg(x)`` strings evaluated to radians, ``$(find pkg)`` to the package
directory) and the same loaders, returning the port's types:
``slam.yaml`` -> (SlamParams, SlamDims, icp path), ``feature.yaml`` ->
FeatureConfig, ``dead_reckoning.yaml`` -> (DRConfig, IMU mount, IMU version),
``gyro.yaml`` -> GyroConfig, ``kalman.yaml`` -> KalmanConfig, ``mapping.yaml``
-> MappingConfig and ``icp.yaml`` (libpointmatcher's schema) -> ICPConfig.
The loaders whose configuration holds tensors take the ``device`` to put
them on.

PyYAML is not needed: ``parse_yaml`` reads the subset of YAML these files
use, with PyYAML's ``safe_load`` results: block mappings and sequences
(including a sequence at its key's indentation and a mapping opened on a
``- `` line), flow lists and mappings, anchors and aliases, plain and quoted
scalars resolved by YAML 1.1's rules (``True``, ``off``, ``9.0e-05``,
``0.``, ``~``), empty values and comments. Anything else (block scalars,
tags, several documents) raises ``ValueError``.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from ..cloud import ICPConfig
from ..estimators import DRConfig, GyroConfig, KalmanConfig

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "config")

_DEG_RE = re.compile(r"^\s*deg\(\s*([-+0-9.eE]+)\s*\)\s*$")
_FIND_RE = re.compile(r"\$\(\s*find\s+([A-Za-z0-9_]+)\s*\)")

# YAML 1.1 implicit types, as PyYAML's resolver reads plain scalars
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _resolve(text: str) -> Any:
    """A plain scalar's value by YAML 1.1's implicit types."""
    if _NULL_RE.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT_RE.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(("inf", "nan")):
            return float(t.replace(".", ""))
        return float(t)
    return text


class _Reader:
    """Recursive-descent reader of the YAML subset named in the module
    docstring."""

    def __init__(self, text: str):
        self.lines = []  # (indent, content) of every line that holds data
        for raw in text.splitlines():
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            if line.startswith(("---", "...", "%")) or "\t" in line[
                    :len(line) - len(line.lstrip())]:
                raise ValueError(f"unsupported YAML line: {raw!r}")
            self.lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.pos = 0
        self.anchors: dict[str, Any] = {}

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.block(self.lines[0][0])
        if self.pos != len(self.lines):
            raise ValueError(f"unexpected YAML line: {self.lines[self.pos][1]!r}")
        return value

    def block(self, indent: int) -> Any:
        content = self.lines[self.pos][1]
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if _split_key(content) is not None:
            return self.mapping(indent)
        self.pos += 1
        return self.node(content, indent)

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            ind, content = self.lines[self.pos]
            if ind != indent or not (content == "-" or content.startswith("- ")):
                break
            rest = content[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                out.append(self.nested(indent))
            elif (rest == "-" or rest.startswith("- ")
                  or (_split_key(rest) is not None and rest[0] not in "[{'\"&*")):
                # "- key: value" or "- - item": a mapping or a sequence
                # whose first entry sits on this line
                col = indent + len(content) - len(rest)
                self.lines[self.pos] = (col, rest)
                out.append(self.block(col))
            else:
                self.pos += 1
                out.append(self.node(rest, indent))
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.pos < len(self.lines):
            ind, content = self.lines[self.pos]
            if ind != indent:
                if ind > indent:
                    raise ValueError(f"bad YAML indentation: {content!r}")
                break
            split = _split_key(content)
            if split is None:
                break
            key, rest = split
            key = self.scalar(key)
            self.pos += 1
            out[key] = self.node(rest, indent) if rest else self.nested(
                indent, key_level=True)
        return out

    def nested(self, indent: int, key_level: bool = False) -> Any:
        """The block under a key or a bare ``-``: deeper lines, or for a key a
        sequence at the key's own indentation; None when there is neither."""
        if self.pos < len(self.lines):
            ind, content = self.lines[self.pos]
            if ind > indent:
                return self.block(ind)
            if key_level and ind == indent and (content == "-"
                                                or content.startswith("- ")):
                return self.sequence(indent)
        return None

    def node(self, text: str, indent: int) -> Any:
        """An inline value: an anchor, an alias, a flow collection or a
        scalar (a plain scalar may go on over deeper lines)."""
        if text.startswith("&"):
            name, _, rest = text[1:].partition(" ")
            rest = rest.strip()
            value = self.node(rest, indent) if rest else self.nested(indent)
            self.anchors[name] = value
            return value
        if text.startswith("*"):
            return self.anchors[text[1:].strip()]
        if text[0] in "[{":
            value, end = self.flow(text, 0)
            if text[end:].strip():
                raise ValueError(f"text after a YAML flow collection: {text!r}")
            return value
        if text[0] in "|>!":
            raise ValueError(f"unsupported YAML node: {text!r}")
        while (text[0] not in "'\"" and self.pos < len(self.lines)
               and self.lines[self.pos][0] > indent):
            text += " " + self.lines[self.pos][1]  # a folded plain scalar
            self.pos += 1
        return self.scalar(text)

    def scalar(self, text: str) -> Any:
        if text[0] == "'" and text.endswith("'") and len(text) > 1:
            return text[1:-1].replace("''", "'")
        if text[0] == '"' and text.endswith('"') and len(text) > 1:
            return text[1:-1].encode().decode("unicode_escape")
        return _resolve(text)

    def flow(self, text: str, i: int):
        """A flow list or mapping starting at ``text[i]``: (value, end)."""
        close = "]" if text[i] == "[" else "}"
        items: list | dict = [] if close == "]" else {}
        i += 1
        while True:
            i = _skip_spaces(text, i)
            if text[i] == close:
                return items, i + 1
            if close == "]":
                value, i = self.flow_item(text, i, ",]")
                items.append(value)
            else:
                key, i = self.flow_item(text, i, ":,}")
                i = _skip_spaces(text, i)
                value = None
                if text[i] == ":":
                    value, i = self.flow_item(text, i + 1, ",}")
                items[key] = value
            i = _skip_spaces(text, i)
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"bad YAML flow collection: {text!r}")

    def flow_item(self, text: str, i: int, stops: str):
        i = _skip_spaces(text, i)
        if text[i] in "[{":
            return self.flow(text, i)
        if text[i] in "'\"":
            end = _quote_end(text, i)
            return self.scalar(text[i:end]), end
        j = i
        while j < len(text) and text[j] not in stops:
            if text[j] == ":" and ":" in stops and (
                    j + 1 == len(text) or text[j + 1] not in " ,}"):
                j += 1  # a colon inside a plain scalar
                continue
            j += 1
        item = text[i:j].strip()
        if item.startswith("*"):
            return self.anchors[item[1:]], j
        return self.scalar(item) if item else None, j


def _skip_spaces(text: str, i: int) -> int:
    while i < len(text) and text[i] == " ":
        i += 1
    if i == len(text):
        raise ValueError(f"unterminated YAML flow collection: {text!r}")
    return i


def _quote_end(text: str, i: int) -> int:
    """The index past the quoted scalar starting at ``text[i]``."""
    q = text[i]
    j = i + 1
    while j < len(text):
        if text[j] == "\\" and q == '"':
            j += 2
            continue
        if text[j] == q:
            if q == "'" and j + 1 < len(text) and text[j + 1] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    raise ValueError(f"unterminated YAML quoted scalar: {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a space,
    outside quotes."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            i = _quote_end(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _split_key(content: str):
    """(key, value text) of a ``key: value`` or ``key:`` line, or None."""
    i = 0
    depth = 0
    while i < len(content):
        c = content[i]
        if c in "'\"" and (i == 0 or content[i - 1] in " [{,:"):
            i = _quote_end(content, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(content)
                                          or content[i + 1] == " "):
            return content[:i].strip(), content[i + 1:].strip()
        i += 1
    return None


def parse_yaml(text: str) -> Any:
    """The value of a YAML document in the subset the module docstring names,
    as PyYAML's ``safe_load`` gives it."""
    return _Reader(text).document()


def _substitute(value: Any) -> Any:
    """Evaluate rosparam-style substitutions: deg(x) and $(find pkg)."""
    if isinstance(value, str):
        m = _DEG_RE.match(value)
        if m:
            return float(np.radians(float(m.group(1))))
        if _FIND_RE.search(value):
            return _FIND_RE.sub(CONFIG_DIR.rstrip("/").rsplit("/", 1)[0], value)
        return value
    if isinstance(value, dict):
        return {k: _substitute(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_substitute(v) for v in value]
    return value


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return _substitute(parse_yaml(f.read())) or {}


def default_path(name: str) -> str:
    return os.path.join(CONFIG_DIR, name)


# ----------------------------------------------------------------------


def load_icp_config(path: str | None = None) -> ICPConfig:
    """Parse a libpointmatcher-schema icp.yaml into ICPConfig:
    KDTreeMatcher.maxDist, MaxDistOutlierFilter.maxDist,
    TrimmedDistOutlierFilter.ratio, CounterTransformationChecker
    .maxIterationCount and DifferentialTransformationChecker {minDiffRotErr,
    minDiffTransErr, smoothLength}; other elements are ignored."""
    raw = load_yaml(path or default_path("icp.yaml"))
    kw: dict[str, Any] = {}
    matcher = raw.get("matcher") or {}
    if "KDTreeMatcher" in matcher and matcher["KDTreeMatcher"]:
        kd = matcher["KDTreeMatcher"]
        if "maxDist" in kd:
            kw["knn_max_dist"] = float(kd["maxDist"])
    for filt in raw.get("outlierFilters") or []:
        if isinstance(filt, dict):
            if "MaxDistOutlierFilter" in filt:
                kw["outlier_max_dist"] = float(filt["MaxDistOutlierFilter"]["maxDist"])
            if "TrimmedDistOutlierFilter" in filt:
                kw["trim_ratio"] = float(filt["TrimmedDistOutlierFilter"]["ratio"])
    for chk in raw.get("transformationCheckers") or []:
        if isinstance(chk, dict):
            if "CounterTransformationChecker" in chk:
                kw["max_iterations"] = int(
                    chk["CounterTransformationChecker"]["maxIterationCount"])
            if "DifferentialTransformationChecker" in chk:
                d = chk["DifferentialTransformationChecker"]
                kw["min_diff_rot"] = float(d.get("minDiffRotErr", 0.01))
                kw["min_diff_trans"] = float(d.get("minDiffTransErr", 0.1))
                kw["smooth_length"] = int(d.get("smoothLength", 4))
    return ICPConfig(**kw)


def load_feature_config(path: str | None = None, max_points: int = 256):
    """feature.yaml -> FeatureConfig."""
    from ..slam.frontend import FeatureConfig

    raw = load_yaml(path or default_path("feature.yaml"))
    cfar = raw.get("CFAR", {})
    filt = raw.get("filter", {})
    return FeatureConfig(
        ntc=int(cfar.get("Ntc", 40)),
        ngc=int(cfar.get("Ngc", 10)),
        pfa=float(cfar.get("Pfa", 0.1)),
        rank=int(cfar.get("rank", 10)),
        alg=str(cfar.get("alg", "SOCA")),
        threshold=float(filt.get("threshold", 65)),
        resolution=float(filt.get("resolution", 0.5)),
        outlier_radius=float(filt.get("radius", 1.0)),
        outlier_min_points=int(filt.get("min_points", 5)),
        skip=int(filt.get("skip", 1)),
        max_points=max_points,
    )


def load_slam_config(path: str | None = None, dims_overrides: dict | None = None,
                     *, device):
    """slam.yaml -> (SlamParams on ``device``, SlamDims, icp_config_path).

    Numeric gates and noise go into SlamParams (float32 values as Python
    numbers, vectors as float32 tensors), structural counts into SlamDims,
    as the JAX loader splits them."""
    from ..slam.core import SlamDims, SlamParams

    raw = load_yaml(path or default_path("slam.yaml"))
    ssm = raw.get("ssm", {})
    nssm = raw.get("nssm", {})

    dims_kw = dict(
        ssm_target_frames=int(ssm.get("target_frames", 3)),
        nssm_source_frames=int(nssm.get("source_frames", 5)),
        nssm_min_st_sep=int(nssm.get("min_st_sep", 8)),
        nssm_cov_samples=int(nssm.get("cov_samples", 30)),
        pcm_queue_slots=int(raw.get("pcm_queue_size", 5)) + 1,
        point_resolution=float(raw.get("point_resolution", 0.5)),
    )
    dims_kw.update(dims_overrides or {})
    icp_path = raw.get("icp_config")
    if icp_path:
        dims_kw.setdefault("icp", load_icp_config(icp_path))
    dims = SlamDims(**dims_kw)

    def f(x):
        return float(np.float32(x))

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    params = SlamParams.default(dims, device)._replace(
        keyframe_duration=f(raw.get("keyframe_duration", 1.0)),
        keyframe_translation=f(raw.get("keyframe_translation", 3.0)),
        keyframe_rotation=f(raw.get("keyframe_rotation", np.radians(30))),
        prior_sigmas=vec(raw.get("prior_sigmas", [0.1, 0.1, 0.01])),
        odom_sigmas=vec(raw.get("odom_sigmas", [0.2, 0.2, 0.02])),
        icp_odom_sigmas=vec(raw.get("icp_odom_sigmas", [0.1, 0.1, 0.01])),
        point_resolution=f(raw.get("point_resolution", 0.5)),
        ssm_enable=bool(ssm.get("enable", True)),
        ssm_min_points=int(ssm.get("min_points", 50)),
        ssm_max_translation=f(ssm.get("max_translation", 3.0)),
        ssm_max_rotation=f(ssm.get("max_rotation", np.radians(30))),
        nssm_enable=bool(nssm.get("enable", True)),
        nssm_min_points=int(nssm.get("min_points", 50)),
        nssm_max_translation=f(nssm.get("max_translation", 10.0)),
        nssm_max_rotation=f(nssm.get("max_rotation", np.radians(60))),
        min_pcm=int(raw.get("min_pcm", 2)),
        pcm_queue_size=int(raw.get("pcm_queue_size", 5)),
    )
    return params, dims, icp_path


def load_dead_reckoning_config(path: str | None = None):
    """dead_reckoning.yaml -> (DRConfig, imu_mount_rpy (3,), imu_version).
    The port's DRConfig keeps the fields dead reckoning reads; the keyframe
    gate's values live in slam.yaml's SlamParams."""
    raw = load_yaml(path or default_path("dead_reckoning.yaml"))
    imu_pose = raw.get("imu_pose", [0, 0, 0, -np.pi / 2, 0, 0])
    cfg = DRConfig(dvl_max_velocity=float(raw.get("dvl_max_velocity", 0.5)),
                   use_gyro=bool(raw.get("use_gyro", False)))
    mount_rpy = np.asarray(imu_pose[3:6], np.float32)
    return cfg, mount_rpy, int(raw.get("imu_version", 1))


def load_gyro_config(path: str | None = None, *, device) -> GyroConfig:
    """gyro.yaml -> GyroConfig, its offset matrix on ``device``."""
    from scipy.spatial.transform import Rotation

    raw = load_yaml(path or default_path("gyro.yaml"))
    off = raw.get("offset", {})
    mat = Rotation.from_euler(
        "xyz",
        [float(off.get("x", 0)), float(off.get("y", 0)), float(off.get("z", 0))],
        degrees=True,
    ).as_matrix()
    return GyroConfig(
        offset_matrix=torch.as_tensor(mat.astype(np.float32), device=device),
        latitude=float(np.radians(raw.get("latitude", 40.70594689371728))),
        sensor_rate=float(raw.get("sensor_rate", 250)),
    )


def load_kalman_config(path: str | None = None, *, device) -> KalmanConfig:
    """kalman.yaml -> KalmanConfig, its matrices float32 on ``device``."""
    raw = load_yaml(path or default_path("kalman.yaml"))

    def a(k):
        return torch.as_tensor(np.asarray(raw[k], np.float32), device=device)

    return KalmanConfig(
        A_imu=a("A_imu"), Q=a("Q"), H_dvl=a("H_dvl"), R_dvl=a("R_dvl"),
        H_imu=a("H_imu"), R_imu=a("R_imu"), H_depth=a("H_depth"),
        R_depth=a("R_depth"), H_gyro=a("H_gyro"), R_gyro=a("R_gyro"),
        dt_imu=float(raw.get("dt_imu", 0.005)),
        dvl_max_velocity=float(raw.get("dvl_max_velocity", 0.5)),
        imu_offset=float(np.radians(raw.get("imu_offset", 180))),
        use_gyro=bool(raw.get("use_gyro", False)),
    )


def load_mapping_config(path: str | None = None, max_keyframes: int = 128):
    """mapping.yaml -> MappingConfig."""
    from ..mapping import MappingConfig

    raw = load_yaml(path or default_path("mapping.yaml"))
    origin = raw.get("origin", [-100.0, -100.0])
    size = raw.get("size", [200.0, 200.0])
    return MappingConfig(
        x0=float(origin[0]),
        y0=float(origin[1]),
        width=float(size[0]),
        height=float(size[1]),
        resolution=float(raw.get("resolution", 0.2)),
        hit_prob=float(raw.get("hit_prob", 0.8)),
        miss_prob=float(raw.get("miss_prob", 0.3)),
        inflation_angle=float(raw.get("inflation_angle", 0.04)),
        inflation_range=float(raw.get("inflation_range", 0.4)),
        inflation_radius=float(raw.get("inflation_radius", 0.5)),
        outlier_filter_radius=float(raw.get("outlier_filter_radius", 5.0)),
        outlier_filter_min_points=int(raw.get("outlier_filter_min_points", 20)),
        min_translation=float(raw.get("min_translation", 0.5)),
        min_rotation=float(raw.get("min_rotation", 0.015)),
        max_keyframes=max_keyframes,
    )
