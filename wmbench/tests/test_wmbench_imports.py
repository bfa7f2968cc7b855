"""Nothing under wmbench/ imports JAX or the JAX package (top-level names
compared whole: winnowmap_tpu_torch begins with winnowmap_tpu), and the
plain reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

WM = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "winnowmap_tpu"}


def _top_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(WM.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    WM)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_top_imports(path) & JAX)


def test_the_comparison_is_by_whole_name(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import winnowmap_tpu_torch.map\n"
                 "from winnowmap_tpu import cli\n")
    assert _top_imports(p) == {"winnowmap_tpu_torch", "winnowmap_tpu"}
    assert _top_imports(p) & JAX == {"winnowmap_tpu"}


@pytest.mark.parametrize("path", sorted((WM / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = _top_imports(path)
    assert not (tops & (JAX | {"winnowmap_tpu_torch", "torch"}))
    assert tops <= {"__future__", "numpy"}
