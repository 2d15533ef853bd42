"""sonar_slam_torch — the sonar SLAM stack in PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of ``sonar_slam_tpu`` (JAX/Pallas), which stays beside it as the
reference; no module here imports JAX. The layout mirrors the reference, so
each module's counterpart has the same path:

  kernels/     CFAR detectors: plain PyTorch versions and the CUDA kernels
  geometry/    SE(2) pose algebra and the pose3 helpers
  cloud/       masked point-cloud ops and batched ICP
  estimators/  dead reckoning, the FOG gyro and the Kalman filter
  graph/       SE(2) Gauss-Newton smoother and PCM
  slam/        sonar geometry, feature front end, scan matching, SLAM core,
               loop refinement, dual sonar and the services
  mapping/     log-odds occupancy mapping and the map metrics
  io/          stream alignment, the synthetic bag simulator, the YAML
               loaders, checkpoints, and the ROS bag reader with its LZ4 codec
  parallel/    config sweeps, the keyframe-axis NSSM reductions and the
               multi-robot merge (lanes and robots as loops on one device)
  utils/       span timing and profiling, logging, the stream registry, viz
  cli/         ``python -m sonar_slam_torch.cli.<name>``: replay, convert_bag,
               simulate_bag, sweep, two_robot_demo, sharded_replay
  config/      the YAML configuration files
  pipeline.py  end-to-end replay on one device
  convert.py   the reference's configuration and state -> the port's

Every entry point takes an explicit ``device``; nothing falls back to
another device.
"""

__version__ = "0.1.0"
