"""orbslam2_tpu_torch: the PyTorch and CUDA port of orbslam2_tpu.

The JAX package (orbslam2_tpu) is the reference; this package mirrors its
module paths and runs on PyTorch, with the TPU kernel rewritten by hand for
NVIDIA Hopper in two forms (csrc/hamming.cu, csrc/hamming_best2.cu) and the
vocabulary descent as a third hand-written kernel (csrc/bow_assign.cu). It
never imports jax or orbslam2_tpu.

The port covers monocular, stereo and RGB-D tracking with local mapping,
place recognition, relocalization, localization mode, loop closing and the
background global BA: System(cfg, device="cuda").track_monocular(...) /
track_stereo(...) / track_rgbd(...), or pipelined with the mapper on its
own thread, System(cfg, device="cuda", async_mapping=True)
.run_sequence(frames, pipelined=True); map files, map merge, the dataset
drivers, the distributed solvers, the live viewer (use_viewer=True) and the
endurance run (python3 -m orbslam2_tpu_torch.endurance_run).
"""
import torch as _torch

# Geometry (pose LM, later BA and triangulation) is accuracy-critical: reduced-
# precision matmuls doubled the ATE in the JAX package (orbslam2_tpu/__init__.py).
# Full f32 everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import Sensor, SlamConfig, OrbParams, load_settings, with_camera  # noqa: F401,E402
from .io.trajectory import save_tum as save_trajectory_tum  # noqa: F401,E402
from .system import System  # noqa: F401,E402

__version__ = "0.1.0"
