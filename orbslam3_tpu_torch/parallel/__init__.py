"""Distribution of the bundle adjustment: the sharded Schur BA
(`dist_ba`) and the mesh it runs on, within one process and across
processes (`multihost`).  Counterpart of `orbslam3_tpu/parallel/`."""
