"""The controls that `correct` has to reject, held to the cells' limits: on
the CPU at a cut size, and on a card at the cell's own size."""
import torch

from benchmark import controls as CTL
from benchmark import harness as H
from benchmark.drivers.gba import gaps
from benchmark.gen import ba_problem as GEN
from test_benchmark_gen import cut_config
from benchmark.reference import ba as REF


def failing(values: dict, workload: str) -> set:
    return {c.name for c in H.checks(values, workload) if not c.ok}


def test_tf32_control_fails_the_gba_limits_at_a_cut_size():
    torch.set_num_threads(4)
    p = GEN.make(cut_config(64, 4096, 65536), 1, "cpu")
    ref = REF.global_ba(p, 5, 1, 2, 24)
    control = gaps(REF.global_ba(p, 5, 1, 2, 24, dtype=torch.float32, tf32=True), ref)
    fp32 = gaps(REF.global_ba(p, 5, 1, 2, 24, dtype=torch.float32), ref)
    assert "cost_gap" in failing(control, "gba-512-cg")
    assert failing(fp32, "gba-512-cg") == set()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.14159265])
    assert REF.to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 3.140625]


def test_tf32_control_fails_at_the_cells_size(card):
    """The control run of PERF.md, one seed: the TF32 control fails a limit,
    the program and the float32 reference pass them all."""
    w = H.cell("gba-512-cg")
    out = CTL.gba_control(H.config(w["config"]), H.traffic(w["traffic"]), 91, program=True)
    assert failing(out["control_tf32"], w["name"])
    assert failing(out["program"], w["name"]) == set()
    assert failing(out["reference_fp32"], w["name"]) == set()
