"""densesurfelmapping_tpu_torch: the PyTorch + CUDA port of the dense surfel
mapping system.

Plain PyTorch functions on tensors, with hand-written CUDA kernels (built for
Hopper, `csrc/`) where the JAX package `densesurfelmapping_tpu` had Pallas
kernels.  The JAX package is the reference this port is tested against; this
package never imports it, nor `jax`.
"""

import torch

from .config import (SurfelMapConfig, CameraIntrinsics, FusionProfile,
                     kitti_config, rgbd_config, mono_config,
                     DRIVE_PROFILE, RGBD_PROFILE, KITTI_00_INTRINSICS)
from .core.state import SurfelBank, SuperpixelState, FrameInput

# Surfel positions must stay exact to f32: TF32 would round matmul and
# convolution inputs to a 10-bit mantissa (the Hopper counterpart of the
# TPU's bf16 default matmul precision, which the JAX package pins to HIGHEST
# in core/geometry.py).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
