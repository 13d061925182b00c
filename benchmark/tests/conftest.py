"""Shared pieces of the benchmark's own tests (run from the checkout's root:
`python -m pytest benchmark/tests -q`). Tests that need a card take the
`card` fixture, which decides at run time whether one is there."""
from __future__ import annotations

import copy
import functools
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness as H


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_gba_ctx(workload: str = "gba-512-cg", seconds: float = 2.0, seed: int = 2**31 + 7,
            cameras: int = 16, points: int = 512, observations: int = 4096,
            device: str = "cpu"):
    """A GBA cell cut for the CPU."""
    w = H.cell(workload)
    conf = copy.deepcopy(H.config(w["config"]))
    conf["problem"].update(cameras=cameras, points=points, observations=observations)
    return SimpleNamespace(workload=w, config=conf, traffic=H.traffic(w["traffic"]),
                           seed=seed, seconds=seconds, trace=False,
                           device=torch.device(device), t_process=time.perf_counter(),
                           checkout=None)


@pytest.fixture
def gba_ctx(monkeypatch):
    """make_gba_ctx, with `ba_solve` on the CG path that the cells' size
    takes by default (at a cut size its default takes the dense Schur step),
    and on one host thread, as benchmark/run.py sets it: several test
    workers, each with a thread a core, would slow each other many times
    over."""
    from orbslam2_tpu_torch.ops import ba as BA

    monkeypatch.setattr(BA, "ba_solve", functools.partial(BA.ba_solve, solver="cg"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make_gba_ctx
    torch.set_num_threads(threads)
