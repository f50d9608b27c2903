"""The import rule, by top-level module names compared whole.

Nothing the benchmark runs on the chip imports ``jax``, ``jaxlib``, ``flax`` or the JAX
package (whose name the port's begins with), and the reference imports none of those nor
the port.  Checked on the sources' import statements and, for what a run loads at run
time, in a subprocess that drives a cell on the CPU.
"""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import HERE, ROOT

JAX = {"jax", "jaxlib", "flax", "feature_level_style_transfer_for_tsc_tpu"}
PORT = "feature_level_style_transfer_for_tsc_tpu_torch"


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def _sources(sub=""):
    return [p for p in (HERE / sub).rglob("*.py") if "tests" not in p.parts]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & JAX, path


def test_the_reference_imports_neither_jax_nor_the_program():
    for path in _sources("reference"):
        assert not _imports(path) & (JAX | {PORT}), path


def test_the_port_name_is_compared_whole():
    assert PORT.split(".")[0] not in JAX
    assert PORT.startswith("feature_level_style_transfer_for_tsc_tpu")


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, json, torch
sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}, {str(HERE / 'tests')!r}]
from conftest import tiny_run
from harness import cell
run, bench = tiny_run("scp2_ethanol.serve_single")
cell.loop(run.traffic).run(run)
print(json.dumps(cell.forbidden_modules()))
print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(JAX)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()
    assert last[-2] == "[]" and last[-1] == "[]"
