"""Trajectory evaluation (the port of `orbslam3_tpu/eval`)."""
