"""The port's top-level names against the JAX package's: every name of
``pde_opt_tpu.__all__`` is in ``pde_opt_tpu_torch.__all__`` except those
still unported, and each resolves to the same kind of object."""

import inspect

import pytest

import pde_opt_tpu as jp
import pde_opt_tpu_torch as tp

# Names of the JAX package not ported yet (ROADMAP.md, queue 1 item 6).
UNPORTED = {"PDEEnv"}


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


def test_legacy_aliases():
    assert tp.OptimizationModel is tp.PDEModel
    assert tp.Grid is tp.Domain
