"""The odometry front ends of ``pipeline.replay``, one module a front end
(``frontend`` in a configuration), each with ``odometry(bag, dims,
dr_config, dev)``."""
