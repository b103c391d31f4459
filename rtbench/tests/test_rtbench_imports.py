"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import ast
import json
import subprocess
import sys

from rtbench_helpers import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_raytracing"}
PORT = "tpu_raytracing_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_sources_import_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert not set(_imports(f)) & {PORT, "harness"}, f


def _module_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_scene_kinds_import_the_port_only_in_their_port_side():
    """The reference loads the scene kinds' files: they import the port
    only inside `port`, and nothing of the harness."""
    groups = [sorted((BENCH / "kinds" / g).glob("*.py"))
              for g in ("camera", "material", "shape", "light")]
    assert all(groups)
    for f in (f for files in groups for f in files):
        assert not set(_module_level_imports(f)) & {PORT, "harness"}, f


def _loaded_after(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(BENCH / 'tests')!r}]
import rtbench_helpers as H
"""


def test_a_run_loads_no_jax():
    loaded = _loaded_after(PRELUDE + """
import io, contextlib, torch, run
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert run.measure(H.tiny_cell("rough_dielectric-beauty", 6),
                       H.Args(), torch, on_card=False) == 0
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert PORT in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(PRELUDE + """
import torch
from reference.render import Lanes, trace
from reference.scene import RefScene
c = json.loads((H.BENCH / "configs" / "coated_diffuse_bunny.json").read_text())
sc = RefScene(c["scene"], 4, 4, H.BENCH, "cpu")
z = torch.zeros(4, dtype=torch.int64)
trace(sc, 1, Lanes(z + 1, z + 2, torch.arange(4)), 8, 4)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not loaded & (FORBIDDEN | {PORT, "harness"})
