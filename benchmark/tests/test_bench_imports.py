"""Nothing the harness or the reference imports has jax, jaxlib, flax or
lis_tpu as its top-level module name (compared whole: lis_tpu_torch is
the system under test), also after a run; and the reference imports
nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "lis_tpu"}

PROBE = r"""
import sys, time
sys.path.insert(0, {root!r})
from benchmark import harness, run, devtrace, roofline, inputs, loader
from benchmark.reference import compare, precond, stencil
for m in harness.manifest()["end_to_end"] + harness.manifest()["per_layer"]:
    harness.reader(m["name"])
for cell in ("hpcg27-192.cg-jacobi", "hpcg27-192.cg-ssor-adds"):
    harness.run_cell(cell, 5, 0.2, True, "cpu", time.perf_counter(),
                     overrides={{"grid": [8, 8, 8]}})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_forbidden_module_is_loaded():
    p = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=harness.ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "lis_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                mods = set(_imports(os.path.join(dirpath, f)))
                assert not mods & FORBIDDEN, (f, mods)
                rel = os.path.relpath(dirpath, harness.HERE)
                if rel.split(os.sep)[0] == "reference":
                    assert "lis_tpu_torch" not in mods, f
