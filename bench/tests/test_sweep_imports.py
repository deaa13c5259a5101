"""No benchmark process holds JAX or the JAX package the port was made
from: top-level module names are compared whole (``repro_torch`` passes,
``repro`` and ``jax`` do not), at run time by ``run.forbidden_modules`` and
here by a run in a fresh process and a scan of the harness's imports."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from bench import run  # noqa: E402


def test_names_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jax_like", "reproducible"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"repro_torch", "jax_like", "reproducible"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert {"repro", "jaxlib"} <= set(run.forbidden_modules())


def test_harness_sources_import_neither():
    for path in (ROOT / "bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.partition(".")[0] not in run.FORBIDDEN, (path, name)


def test_run_refuses_with_a_forbidden_module_loaded(monkeypatch, tmp_path):
    from bench.tests.test_sweep_harness import drive, make_root
    root = make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    rc, line, err = drive(root)
    assert rc != 0 and line is None and "repro" in err


def test_a_run_loads_neither_in_a_fresh_process(tmp_path):
    code = (
        "import io, sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from bench.tests import test_sweep_harness as h\n"
        "rc, line, err = h.drive(h.make_root(Path.cwd()))\n"
        "print(json.dumps({'rc': rc, 'correct': line['correct'],\n"
        "                  'top': sorted({m.partition('.')[0] for m in sys.modules})}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["correct"] is True
    assert "repro_torch" in got["top"]
    assert not set(got["top"]) & run.FORBIDDEN
