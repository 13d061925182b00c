"""Host-to-device transfers that never stall the host.

A copy from pageable host memory to the card waits for the copy to finish
(and `torch.cuda.set_sync_debug_mode("error")` rejects it). The port's
device programs therefore take:

- `upload`: a host array staged in pinned memory and copied without
  waiting, on the current stream (the pinned block is kept until the copy
  has run);
- `constant`: a host-built table (filter weights, sampling patterns),
  uploaded once per device and kept. The one upload runs under a lock and
  is waited for before the table is published (`upload_and_wait`), so any
  thread, on any stream, may read the table once it has it.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_CONSTANTS: dict = {}
_CONSTANTS_LOCK = threading.Lock()


def upload(a, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device` (asynchronous on a CUDA device).
    The tensor never shares memory with `a`: on the CPU it is a copy, so a
    later write to the host array (by the mapping thread, say) cannot
    reach a device program that is still reading it."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(a)).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        device, non_blocking=True)


def upload_and_wait(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device`, returned only once the copy has
    finished on the card: a tensor another thread may read at once, from
    any stream."""
    device = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return t


def constant(key, make, device: torch.device) -> torch.Tensor:
    """The table `make()` (a numpy array) on `device`, built and uploaded on
    the first call for (key, device) only. Check and fill hold a lock, and
    the table is published only after its upload has finished."""
    k = (key, str(device))
    t = _CONSTANTS.get(k)
    if t is None:
        with _CONSTANTS_LOCK:
            t = _CONSTANTS.get(k)
            if t is None:
                t = upload_and_wait(make(), device)
                _CONSTANTS[k] = t
    return t
