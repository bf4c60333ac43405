"""Nothing of the benchmark imports JAX, Flax or the JAX package
(``repro``; top-level names compared whole, so ``repro_torch`` is not it),
and the reference imports nothing of the port."""

import ast

import pytest

from portbench import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(manifest.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(manifest.HERE))
                              for p in SOURCES])
def test_no_jax_nor_the_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in (manifest.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(top_level_imports(path)), path


def test_banned_modules_compares_whole_names():
    assert harness.banned_modules(["repro_torch", "repro_torch.models.lm",
                                   "reproduce", "torch"]) == []
    assert harness.banned_modules(["repro.core", "jax.numpy", "jaxlib",
                                   "flax.linen", "numpy"]) == \
        ["flax", "jax", "jaxlib", "repro"]
