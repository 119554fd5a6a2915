"""orbslam3_tpu_torch: the PyTorch + CUDA port of orbslam3_tpu for NVIDIA Hopper.

The JAX package `orbslam3_tpu` is the reference; every module here sits at
the same relative path as the JAX module it is tested against.  This
package imports `torch` and never `jax` or `orbslam3_tpu`, so that it runs
where JAX is not installed; the only thing it shares with the JAX package
is the data file `orbslam3_tpu/data/orb_pattern.npy`, read by its path.

Precision policy: every float32 matrix product runs in full float32.  The
JAX package pins `Precision.HIGHEST` for the banded blur
(`orbslam3_tpu/ops/image.py:75-79`) and for the geometry; TF32 on Hopper
is the same trap (it keeps ~3 decimal digits and flips rounded blur
values and BRIEF comparisons), so it is switched off for matmuls and for
cuDNN, and the float32 matmul precision is "highest".
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO_ROOT, "orbslam3_tpu", "data")

__version__ = "0.1.0"
