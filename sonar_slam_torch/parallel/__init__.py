"""Config sweeps, the keyframe-axis reductions and multi-robot merging.

Counterpart of ``sonar_slam_tpu/parallel/``. On one device the sweep's
lanes and the robots each run as one lane-batched scan (``slam/lanes.py``,
as the JAX package's ``vmap`` and ``shard_map`` do), and the keyframe axis
is one batch. The JAX package's device mesh (``jax.sharding``,
``shard_map``, ``all_gather``) is ``mesh``: SPMD ranks, one process a card
(ranks share cards where there are more ranks than cards), each computing
its contiguous block of the sharded axis, the results all-gathered over a
gloo group:

* ``sweep``: one keyframe stream replayed under many ``SlamParams`` lanes
  (BASELINE.json configs[4], 64 CFAR/ICP hyperparameter configs), every
  lane advancing through each keyframe step together, each lane its lone
  scan's result (bit for bit on a card); with a mesh, each rank's block of
  lanes (``make_config_mesh``).
* ``keyframe_shard``: the NSSM gate and the global transform over all
  keyframes at once, or K-sharded over a mesh (``kf_sharding``).
* ``multi_robot``: every robot's scan as a lane of one batched scan (each
  lane its own keyframe stream; with a mesh, each rank's block of robots),
  keyframe summaries and their exchange, inter-robot loop proposals (the
  pairs' Sobol searches in one batch), PCM vetting and the merged pose
  graph.
* ``mesh``: the ranks (``spawn``), the mesh value, ``shard`` and
  ``gather``.
"""

from .sweep import make_config_mesh, stack_params, sweep_scan
from .multi_robot import exchange_keyframes, merge_interrobot_factors
from .keyframe_shard import kf_sharding
