"""Nothing under perfbench/ imports JAX, flax, optax or the JAX package,
compared by whole top-level module names; the reference imports nothing of
the port; the harness, the calibration and the reference's training loop
name no model and no task."""

import ast
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "egovlpv2_tpu"}
SOURCES = sorted(HOME.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HOME)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HOME / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing",
                                       "torch", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference")


def test_whole_names_not_prefixes():
    # the port's name begins with the JAX package's stem: a prefix test
    # would refuse it, a whole-name test does not
    assert "egovlpv2_torch" not in FORBIDDEN
    assert top_level_imports(HOME / "harness.py") >= {"torch", "perfbench"}


@pytest.mark.parametrize("name", ["harness.py", "calibrate.py",
                                  "reference/train.py"])
def test_the_yardstick_names_no_model_and_no_task(name):
    tree = ast.parse((HOME / name).read_text())
    imported = {(node.module, a.name) for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                for a in node.names}
    assert not [m for m, _ in imported
                if m.startswith("egovlpv2_torch.models")]
    assert not [a for _, a in imported if a in ("EgoVLPv2", "model")]
    words = {node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and isinstance(node.value,
                                                              str)}
    assert not words & {"pretrain", "dual"}
