"""sonar_slam_torch — the sonar SLAM stack in PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of ``sonar_slam_tpu`` (JAX/Pallas), which stays beside it as the
reference; no module here imports JAX. The layout mirrors the reference, so
each module's counterpart has the same path:

  kernels/     CFAR detectors: plain PyTorch versions and the CUDA kernel
  geometry/    SE(2) pose algebra and the pose3 helpers
  cloud/       masked point-cloud ops and batched ICP
  estimators/  dead reckoning
  graph/       SE(2) Gauss-Newton smoother and PCM
  slam/        sonar geometry, feature front end, scan matching, SLAM core
  io/          stream alignment and the synthetic bag simulator
  pipeline.py  end-to-end replay on one device
  convert.py   the reference's configuration and state -> the port's

Every entry point takes an explicit ``device``; nothing falls back to
another device.
"""

__version__ = "0.1.0"
