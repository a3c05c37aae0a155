"""Nothing the benchmark runs loads JAX, flax or the JAX package, compared
by whole top-level name; the plain reference loads nothing of the program
either."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)

PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "rt3d", "rt3d_torch"}}))
"""


def _loaded(imports):
    p = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, imports=imports)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax():
    imports = "\n".join([
        "import bench_port.run, bench_port.check, bench_port.drive, bench_port.tracer",
        "import bench_port.control, bench_port.flops, bench_port.roofline",
        "from bench_port.run import build_program",
        "import rt3d_torch.runtime.driver, rt3d_torch.pipeline.step, rt3d_torch.models.quant",
        "from bench_port.reference.pipeline.step import build_pipeline"])
    assert _loaded(imports) == "['rt3d_torch']"


def test_reference_loads_nothing_of_the_program():
    imports = "\n".join([
        "import bench_port.check, bench_port.synthetic, bench_port.stats",
        "from bench_port.reference.pipeline.step import build_pipeline",
        "from bench_port.reference import config"])
    assert _loaded(imports) == "[]"


def test_reference_sources_import_only_torch_numpy_and_themselves():
    allowed = ("bench_port", "__future__", "typing", "dataclasses", "torch", "numpy", "math",
               "contextlib", "json")
    for dirpath, _, files in os.walk(os.path.join(PKG, "reference")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] in allowed, (f, n)
                    assert not n.startswith("bench_port.") or n.startswith("bench_port.reference"), (f, n)
