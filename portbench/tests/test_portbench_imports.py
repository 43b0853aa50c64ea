"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names (the
part before the first dot) are compared whole: binius_ntt_tpu_torch
begins with binius_ntt_tpu."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "binius_ntt_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not imported_tops(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "binius_ntt_tpu_torch" not in imported_tops(path), path
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_whole_match_is_on_top_level_names():
    assert "binius_ntt_tpu_torch".split(".")[0] not in FORBIDDEN


CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
out = {{}}
for wl, ov in (("ntt128-2e24-r2.compact", {{"log_h": 7, "columns": 2}}),
               ("sumcheck128-28v-c2.prove", {{"num_vars": 7}})):
    for traced in (False, True):
        r = run.run(wl, 2 ** 33 + 5, 0.3, traced, device="cpu",
                    overrides=ov)
        assert r["correct"], r
print(json.dumps({{"forbidden": run.forbidden_modules(),
                  "reference_imports": sorted(
                      m for m in sys.modules
                      if m.startswith("portbench.reference"))}}))
"""


def test_a_cpu_run_loads_no_jax():
    """What a run imports, seen in its own process."""
    p = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "portbench.reference.tower" in got["reference_imports"]
