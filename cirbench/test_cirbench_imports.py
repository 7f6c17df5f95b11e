"""The import check, and the references' independence from the program."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from conftest import REPO


def test_import_check_fails_on_a_planted_jax():
    from cirbench import harness

    assert "jax" not in harness.forbidden_modules()
    sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
    try:
        assert harness.forbidden_modules() == ["jax"]
    finally:
        del sys.modules["jax.numpy"]


def test_import_check_passes_the_port():
    from cirbench import harness

    import spn4cir_tpu_torch.models.clip4cir  # noqa: F401

    assert "spn4cir_tpu" not in harness.forbidden_modules()


def test_references_import_nothing_of_the_program():
    for path in (REPO / "cirbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "spn4cir_tpu_torch", "spn4cir_tpu", "jax", "tests"), (
                    path, name)


def test_a_reference_process_loads_no_program_module():
    code = ("import sys; import cirbench.reference.clip4cir, "
            "cirbench.reference.blip24cir, cirbench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'spn4cir_tpu_torch', 'spn4cir_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_load_generator_imports_no_torch():
    code = ("import sys, cirbench.loadgen; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def test_harness_sources_name_no_jax_package():
    for path in (REPO / "cirbench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module or ""])
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                   "spn4cir_tpu"), (path, m)
