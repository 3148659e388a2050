"""No module of the benchmark imports JAX, Flax or the JAX package, and no
reference imports anything of the program; both compared by each import's
top-level name, whole (``pde_opt_tpu_torch`` is not ``pde_opt_tpu``)."""

import ast

import pytest

from portbench import core

SOURCES = sorted(core.HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((core.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "pde_opt_tpu_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    assert top_level_imports(core.HERE / "drivers" / "rollout.py") >= {"pde_opt_tpu_torch"}
    import pde_opt_tpu_torch.envs  # noqa: F401

    assert not core.forbidden_modules()
