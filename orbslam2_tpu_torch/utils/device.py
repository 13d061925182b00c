"""Host-to-device transfers that never stall the host.

A copy from pageable host memory to the card waits for the copy to finish
(and `torch.cuda.set_sync_debug_mode("error")` rejects it). The port's
device programs therefore take:

- `upload`: a host array staged in pinned memory and copied without
  waiting, on the current stream (the pinned block is kept until the copy
  has run);
- `constant`: a host-built table (filter weights, sampling patterns),
  uploaded once per device and kept. The one upload waits for its copy, so
  any stream may read the table afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def upload(a, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device` (asynchronous on a CUDA device).
    The tensor never shares memory with `a`: on the CPU it is a copy, so a
    later write to the host array (by the mapping thread, say) cannot
    reach a device program that is still reading it."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(a)).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        device, non_blocking=True)


def constant(key, make, device: torch.device) -> torch.Tensor:
    """The table `make()` (a numpy array) on `device`, built and uploaded on
    the first call for (key, device) only."""
    k = (key, str(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        _CONSTANTS[k] = t
    return t
