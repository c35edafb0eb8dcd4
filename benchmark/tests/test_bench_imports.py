"""Nothing under ``benchmark/`` brings in JAX or the JAX package, and the
reference brings in nothing of the program: by the top-level name of each
module, compared whole (``superscreen_tpu_torch`` begins with
``superscreen_tpu``)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def imported_top_levels(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not imported_top_levels(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_program(path):
    assert "superscreen_tpu_torch" not in imported_top_levels(path)


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys; print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    modules = _modules_after(
        "from benchmark.reference import films, mesh, config"
    )
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {"superscreen_tpu_torch", *harness.FORBIDDEN}


def test_a_run_of_the_program_loads_no_jax():
    """What a run imports of the program, its kinds of call and its spans."""
    modules = _modules_after(
        "import superscreen_tpu_torch, superscreen_tpu_torch.squids.scanning, superscreen_tpu_torch.parallel\n"
        "from benchmark import harness, drives, spans, trace, control\n"
        "for p in (harness.ROOT / 'benchmark' / 'entries').glob('*.py'): harness.entry_class(p.stem)\n"
        "import torch.profiler"
    )
    assert harness.forbidden_modules(modules) == []
