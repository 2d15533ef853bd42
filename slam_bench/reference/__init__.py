"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch modules, as they stood when the benchmark was written.

It imports nothing of the port, of JAX or of the JAX package, so a change to
the port cannot move the yardstick. The copies are verbatim but for these
departures:

* ``kernels/cfar_cuda.py`` keeps only the plain detectors: ``cfar_detect``
  runs ``cfar_plain`` / ``cfar_os_plain`` on every device (the port's sum
  kernel agrees with ``cfar_plain`` bit for bit on the card);
* ``precision.py``'s ``pin_fp32`` does nothing: ``precision.use`` sets the
  matmul precision for a whole reference run (float32, or TF32 for the
  control);
* only what the two cells' stages run is kept: single-lane ICP and graph
  sums (no sweep lanes), ``refine_loops`` without a device mesh, and no
  image ops, bag-reader helpers or incremental mapping API;
* the subpackages' ``__init__`` export only what the copied modules need.

``stages.py`` (not a copy) chains the stages of ``pipeline.replay`` and of
the live nodes; ``odometry/<frontend>.py`` holds each odometry front end's
stage, found by the configuration's ``frontend``.
"""
