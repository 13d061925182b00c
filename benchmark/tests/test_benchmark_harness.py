"""The harness: finding a cell's files by name, the checks, the result line,
and the refusals (no card; JAX loaded)."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness as H
from benchmark import run as R

REPO = Path(H.__file__).resolve().parent.parent


def test_every_cell_finds_its_files():
    spec = H.load_json(H.SPEC)
    for w in spec["workloads"]:
        assert H.cell(w["name"]) is not None
        conf = H.config(w["config"])
        assert conf["name"] == w["config"] and H.generator(conf["generator"]).make
        t = H.traffic(w["traffic"])
        assert H.driver(t["driver"]).run
        lim = H.limits(w["name"])
        assert lim and all(len(v) == 1 for v in lim.values())
        for trace in (False, True):
            for m in H.metrics_of(w["name"], trace):
                assert H.reader(m["name"]).read


def test_a_new_cell_is_found_by_name_alone(tmp_path, monkeypatch):
    root = tmp_path / "benchmark"
    shutil.copytree(H.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = H.load_json(H.SPEC)
    (root / "configs" / "new-config.json").write_text(
        json.dumps({"name": "new-config", "generator": "new_gen"}))
    (root / "gen" / "new_gen.py").write_text("def make(config, seed, device):\n"
                                             "    return {'seed': seed}\n")
    (root / "traffic" / "new-mix.json").write_text(json.dumps({"driver": "gba"}))
    (root / "limits" / "new-cell.json").write_text(
        json.dumps({"checks": {"x": {"at_most": 1.0}}}))
    (root / "metrics" / "new_metric.new.py").write_text("def read(run):\n    return 42.0\n")
    spec["workloads"].append({"name": "new-cell", "config": "new-config",
                              "traffic": "new-mix", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "new_metric.new", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "device",
                              "moves": "gba_solve_s", "workloads": ["new-cell"]})
    next(m for m in spec["end_to_end"] if m["name"] == "gba_solve_s")["workloads"].append(
        "new-cell")
    monkeypatch.setattr(H, "ROOT", root)
    assert H.cell("new-cell", spec)["traffic"] == "new-mix"
    assert H.config("new-config")["name"] == "new-config"
    assert H.generator(H.config("new-config")["generator"]).make({}, 3, "cpu") == {"seed": 3}
    assert H.traffic("new-mix")["driver"] == "gba"
    assert [c.ok for c in H.checks({"x": 0.5}, "new-cell")] == [True]
    names = [m["name"] for m in H.metrics_of("new-cell", True, spec)]
    assert names == ["new_metric.new"]
    assert H.reader("new_metric.new").read(None) == 42.0


def test_checks_by_direction():
    assert H.Check("a", 1.0, "at_most", 1.0).ok
    assert not H.Check("a", 1.1, "at_most", 1.0).ok
    assert H.Check("a", 90.0, "at_least", 90.0).ok
    assert not H.Check("a", 89.0, "at_least", 90.0).ok
    assert not H.Check("a", float("nan"), "at_most", 1.0).ok
    assert not H.Check("a", 0.0, "at_most", None).ok


def test_the_last_line_has_the_five_keys_and_the_checks_last(monkeypatch):
    run = H.Run(setup_s=3.0, window_s=10.0, attempted=5, failed=0,
                values={"cost_gap": 1e-9}, memory_peak_bytes=123, chips=1)
    run.data.update(gba_s=[1.0, 1.5])
    monkeypatch.setattr(H, "limits", lambda w: {"cost_gap": {"at_most": 1e-6}})
    checks, line = R.result(run, H.cell("gba-512-cg"), False, "NVIDIA H100 80GB HBM3")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"gba_solve_s", "setup_s"}
    assert line["metrics"]["gba_solve_s"] == {"value": 1.25, "unit": "s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                              "count": 1, "memory_peak_bytes": 123}
    assert line["checks"] == {"cost_gap": {"value": 1e-9, "at_most": 1e-6}}
    json.dumps(line)


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gba-512-cg",
                          "--seed", "1", "--seconds", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if out.returncode == 0:
        pytest.skip("a card is here")
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_a_checkout_without_the_port_fails_without_a_result(tmp_path):
    shutil.copytree(H.ROOT, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.SPEC, tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gba-512-cg",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "orbslam2_tpu_torch_lookalike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "orbslam2_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert H.forbidden_modules() == ["jax", "orbslam2_tpu"]
