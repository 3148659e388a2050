"""The port's public names against the JAX package's: every name of
``pde_opt_tpu.__all__`` is in ``pde_opt_tpu_torch.__all__``, each resolves
to the same kind of object, and each module's ``__all__`` holds its JAX
counterpart's, less the exceptions listed with their reasons."""

import ast
import inspect
from pathlib import Path

import pytest

import pde_opt_tpu as jp
import pde_opt_tpu_torch as tp

# Top-level names of the JAX package not ported yet: none.
UNPORTED = set()

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "pde_opt_tpu", ROOT / "pde_opt_tpu_torch"

# JAX modules (paths relative to the package) whose names the port leaves
# out, with the reason: the names left out, or None for a module with no
# counterpart file.
EXCEPTIONS = {
    # The equinox-style module system: torch.nn.Module takes its place
    # (ROADMAP.md, "Not queued").
    "utils/modules.py": None,
    "utils/__init__.py": ("module",),
    # A host-clock env-steps/s counter that nothing read: the port times
    # the host with its spans (named_scope) instead.
    "utils/metrics.py": ("Throughput",),
}


def _all_of(path: Path):
    """A module's ``__all__`` by reading its source (no import: the JAX
    side's modules import jax and the port's optional ones gymnasium or
    sympy)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                     if _all_of(p) is not None)


def test_all_holds_the_jax_names_less_the_unported():
    missing = set(jp.__all__) - set(tp.__all__)
    assert missing == UNPORTED, sorted(missing)
    assert not UNPORTED & set(tp.__all__)


@pytest.mark.parametrize("name", sorted(set(jp.__all__) - UNPORTED))
def test_top_level_name_resolves(name):
    ported, ref = getattr(tp, name), getattr(jp, name)
    assert inspect.isclass(ported) == inspect.isclass(ref)
    assert callable(ported) == callable(ref)
    if inspect.isclass(ref):
        assert ported.__name__ == ref.__name__


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_all_holds_the_jax_names(module):
    """Each JAX module's ``__all__`` is in its counterpart's ``__all__``."""
    excepted = EXCEPTIONS.get(module, ())
    port = PORT_PKG / module
    if excepted is None:
        assert not port.exists(), f"{module} is ported: take it off the exceptions"
        return
    assert port.exists(), f"pde_opt_tpu_torch/{module} is missing"
    missing = _all_of(JAX_PKG / module) - (_all_of(port) or set())
    assert missing == set(excepted), sorted(missing)


def test_legacy_aliases():
    assert tp.OptimizationModel is tp.PDEModel
    assert tp.Grid is tp.Domain
    from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic, CahnHilliardSIFFT

    assert CahnHilliardSIFFT is CahnHilliard2DPeriodic


SCALE_OUT_FILES = sorted((PORT_PKG / "parallel").glob("*.py")) + [ROOT / "scripts" / "torch_multichip.py"]


@pytest.mark.parametrize("path", SCALE_OUT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_scale_out_imports_neither_jax_nor_the_jax_package(path):
    """The scale-out modules and the four-card script import torch, never
    jax or ``pde_opt_tpu`` (its spawned ranks import only the port)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pde_opt_tpu"), f"{path.name} imports {name}"
