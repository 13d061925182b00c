"""Timing of device work with CUDA events (chip_smoke.py, the bench, the
probes and the kernel profiler), and the least time the card could take.

Two clocks and two cache states:

- `time_ms`: mean time per call over back-to-back calls, the launch cost
  included: what a caller pays.
- `queued_ms`: device time per call, from events around calls queued behind
  a spin kernel: the host has issued every call before the device starts
  the first, so the host's launch gaps are hidden.
- warm: every call reuses the same buffers, which then sit in the 50 MB L2
  (the real callers' case: they consume a result at once). cold: the calls
  walk over more distinct buffers than L2 holds (`cold_count` says how many),
  so every byte comes from and goes to device memory, as a byte bound assumes.
"""
from __future__ import annotations

import subprocess

import torch

L2_BYTES = 50 * 1000 * 1000  # H100
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# H100 SXM data sheet, outside the tensor cores. The sheet gives no integer
# rate there, so integer work is counted at the float32 rate: the bound it
# gives can only be lower than the true one
FP32_OPS_PER_S, FP64_OPS_PER_S = 67e12, 34e12


def bound(n_bytes: int, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) over the data-sheet memory rate
    against its operations over `ops_per_s` (a data-sheet peak, or the
    tensor-core instruction rate measured in the run). Milliseconds, and
    which of the two bounds it."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return dict(bound_ms=max(by_bytes, by_ops), bound_bytes_ms=by_bytes,
                bound_ops_ms=by_ops,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def card() -> dict:
    """{"name", "power_limit_w", "count"}: the first card as `card_line`
    reads it, and the number of CUDA devices."""
    name, limit = (part.strip() for part in card_line().rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]),
            "count": torch.cuda.device_count()}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 50, warm: int = 3) -> float:
    """Mean time per call of fn() over reps back-to-back calls, from CUDA
    events, after `warm` calls: what a caller pays, launch cost included."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 10) -> float | None:
    """Device time per call of fn() from CUDA events around reps calls
    queued behind a spin kernel: the host has issued every call before the
    device starts the first, so the events span the kernels run back to
    back, without the host's launch gaps that time_ms includes. None when
    the spin ended before the host had issued them all."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of spinning
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def cold_count(bytes_per_call: int) -> int:
    """How many distinct buffer sets a cold timing walks over: at least
    twice the L2's size in all, between 10 and 100 sets."""
    return min(100, max(10, -(-2 * L2_BYTES // max(1, bytes_per_call))))


def queued_cold_ms(fn_of, n_sets: int) -> float | None:
    """queued_ms of fn_of(i) over i = 0 .. n_sets-1, each call on its own
    buffer set; a first pass over all sets leaves the L2 holding only the
    last of them."""
    for i in range(n_sets):
        fn_of(i)
    calls = iter(range(n_sets + 1))
    return queued_ms(lambda: fn_of(next(calls) % n_sets), reps=n_sets)


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"
