"""Command-line entry points, run as ``python -m sonar_slam_torch.cli.<name>``:

  simulate_bag  write a synthetic survey as an .npz bundle
  convert_bag   convert a ROS1 bag of the BlueROV topics into a bundle
  replay        replay a bundle (or a simulated survey) on a CUDA card, or on
                the CPU with ``--cpu``, and write the trajectory, the carry,
                the occupancy map and the submap dump
"""
