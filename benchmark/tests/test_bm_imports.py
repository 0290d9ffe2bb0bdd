"""What a run loads: nothing of JAX or of the JAX package, and the
reference nothing of the program (top-level module names compared
whole)."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "opengl_ray_tracing_framework_tpu"}
PORT = "opengl_ray_tracing_framework_tpu_torch"


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r})"
         f"\n{code}\nprint(__import__('json').dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(
        "import benchmark.reference.render, benchmark.reference.cast, "
        "benchmark.reference.lowp, benchmark.reference.hdr")
    assert PORT not in mods and not mods & JAX


def test_a_run_loads_no_jax():
    mods = _top_level(
        "from benchmark import run\n"
        "from benchmark.tests.tiny import tiny\n"
        "assert run.main(['--workload', 'glass82k.fwd', '--seed', '5', "
        "'--seconds', '0.2', '--trace', '0'], device='cpu', "
        "overrides=tiny) == 0\n"
        "assert not run.loaded_forbidden()")
    assert PORT in mods and not mods & JAX
