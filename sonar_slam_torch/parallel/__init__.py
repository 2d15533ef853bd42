"""Config sweeps, the keyframe-axis reductions and multi-robot merging.

Counterpart of ``sonar_slam_tpu/parallel/``. The JAX package runs sweep
lanes and robots on the lanes of a device mesh (``vmap``, ``shard_map``,
``all_gather``). One card has no mesh: here the sweep's lanes and the
robots each run as one lane-batched scan on one device (``slam/lanes.py``,
as the JAX package's ``vmap`` and ``shard_map`` do), and the keyframe axis
is one batch:

* ``sweep``: one keyframe stream replayed under many ``SlamParams`` lanes
  (BASELINE.json configs[4], 64 CFAR/ICP hyperparameter configs), every
  lane advancing through each keyframe step together, each lane its lone
  scan's result (bit for bit on a card).
* ``keyframe_shard``: the NSSM gate and the global transform over all
  keyframes at once.
* ``multi_robot``: every robot's scan as a lane of one batched scan (each
  lane its own keyframe stream), keyframe summaries, inter-robot loop
  proposals (the pairs' Sobol searches in one batch), PCM vetting and the
  merged pose graph.

``make_config_mesh`` has no counterpart.
"""

from .sweep import stack_params, sweep_scan
from .multi_robot import exchange_keyframes, merge_interrobot_factors
