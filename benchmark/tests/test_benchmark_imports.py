"""What the harness loads: no JAX and no JAX package anywhere, and nothing of
the port in the reference (each in a fresh interpreter)."""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys\n{code}\nimport json\n"
                          f"print(json.dumps({TOP}))"], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    mods = loaded("import benchmark.run, benchmark.controls, benchmark.drivers.gba, "
                  "benchmark.reference.ba\n"
                  "import orbslam2_tpu_torch, orbslam2_tpu_torch.ops.ba")
    assert not mods & {"jax", "jaxlib", "flax", "orbslam2_tpu"}
    assert "orbslam2_tpu_torch" in mods


def test_the_reference_imports_nothing_of_the_port():
    mods = loaded("import benchmark.reference.ba, benchmark.gen.ba_problem, benchmark.counts")
    assert not mods & {"jax", "jaxlib", "flax", "orbslam2_tpu", "orbslam2_tpu_torch"}
