"""Parameter-tree partition/combine utilities (PyTorch port of
:mod:`pde_opt_tpu.utils.ptree`).

A parameter tree is a nest of dicts, lists and tuples whose leaves mix
tensors, numpy arrays, python numbers and callables.  Optimizers see only
the inexact-array leaves; everything else is carried through statically.
``None`` is a leaf that stands for "absent", as in the JAX package.

An :class:`torch.nn.Module` is a node, as the JAX package's pytree modules
are: its leaves are its parameters, its submodules' included.  Mapping over
a module gives a shallow copy of the same class whose parameter slots hold
the mapped values, so :func:`partition` leaves the module's structure on the
static side and its parameters on the dynamic side, and :func:`combine`
gives back a module of the caller's class that computes with the dynamic
tensors (gradients flow into them).  The caller's module is never changed.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, List

import numpy as np
import torch
from torch import nn

from .device import resolve_device

__all__ = [
    "tree_map",
    "tree_leaves",
    "is_array_like",
    "is_inexact_array_like",
    "partition",
    "combine",
    "as_arrays",
    "from_numpy",
    "tree_size",
    "ravel_params",
]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    if isinstance(tree, nn.Module):
        return _module_map(fn, tree, *rest)
    return fn(tree, *rest)


def _module_map(fn: Callable, module: nn.Module, *rest: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` whose parameter slots (its submodules'
    too, each copied) hold ``fn`` of the parameters at the same names in
    ``module`` and ``rest``.  Attribute access on the copy reads the new
    values, so a mapped tensor that requires grad takes part in autograd."""
    out = copy.copy(module)
    params = {k: tree_map(fn, p, *(r._parameters[k] for r in rest))
              for k, p in module._parameters.items()}
    mods = {k: None if m is None else _module_map(fn, m, *(r._modules[k] for r in rest))
            for k, m in module._modules.items()}
    # Past nn.Module.__setattr__, which admits only Parameters in these slots.
    object.__setattr__(out, "_parameters", params)
    object.__setattr__(out, "_modules", mods)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order, ``None`` leaves dropped."""
    out: List[Any] = []
    tree_map(lambda x: out.append(x) if x is not None else None, tree)
    return out


def is_array_like(x: Any) -> bool:
    """True for tensors, numpy arrays and scalars, and python numbers."""
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int, float, complex))


def is_inexact_array_like(x: Any) -> bool:
    """True for floating/complex tensors and arrays and python floats/complex.

    The filter that splits trainable leaves from static structure
    (``eqx.is_inexact_array_like`` in the reference).
    """
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() or x.is_complex()
    if isinstance(x, (np.ndarray, np.generic)):
        return np.issubdtype(x.dtype, np.inexact)
    return isinstance(x, (float, complex))


def partition(tree: Any, filter_fn: Callable[[Any], bool] = is_inexact_array_like):
    """Split ``tree`` into (dynamic, static) trees of the same structure.

    Leaves passing ``filter_fn`` stay in the dynamic tree (static side gets
    ``None``); all other leaves go to the static tree (dynamic side
    ``None``).  ``combine(dynamic, static)`` inverts this.
    """
    dynamic = tree_map(lambda x: x if filter_fn(x) else None, tree)
    static = tree_map(lambda x: None if filter_fn(x) else x, tree)
    return dynamic, static


def combine(dynamic: Any, static: Any) -> Any:
    """Inverse of :func:`partition`: take the non-None leaf at each position."""
    return tree_map(lambda d, s: s if d is None else d, dynamic, static)


def as_arrays(tree: Any) -> Any:
    """Convert every non-None leaf to a tensor (python floats take torch's
    default dtype; tensors keep theirs)."""
    return tree_map(lambda x: None if x is None else torch.as_tensor(x), tree)


def from_numpy(tree: Any, device=None) -> Any:
    """Carry a JAX parameter tree into the port.

    Array leaves (numpy arrays and scalars, or any other object with
    ``__array__``, such as a JAX array) become tensors of the same dtype on
    ``device`` (default: the card, ``"cuda"``, as every entry point of the
    port); tensors, a module's parameters included, move to ``device``;
    the JAX package's coefficient modules (the Legendre expansions,
    ``PeriodicCNN``, ``Mixer2d``) become the port's modules with the same
    numbers (:func:`pde_opt_tpu_torch.models.functions.function_from_numpy`);
    python numbers, other callables and ``None`` are kept as they are.
    """
    from ..models.functions import function_from_numpy

    device = resolve_device("cuda" if device is None else device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
            return torch.as_tensor(np.array(x), device=device)
        if not isinstance(x, nn.Module):
            module = function_from_numpy(x, device)
            if module is not None:
                return module
        return x

    return tree_map(leaf, tree)


def tree_size(tree: Any) -> int:
    """Total number of scalar elements across the array leaves (tensors,
    numpy arrays and python numbers), a module's parameters included."""
    return sum(x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))
               for x in tree_leaves(tree)
               if isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, complex)))


def ravel_params(tree: Any):
    """Flatten the inexact leaves of ``tree`` into one 1D tensor.

    Returns ``(vector, unravel)``.  ``vector`` is a new tensor, detached
    from the leaves, in the dtype the tensor leaves promote to (python
    floats take part as weak scalars, as in the JAX package; a tree of
    python floats alone gives torch's default dtype) on the first tensor
    leaf's device.  ``unravel(vec)`` rebuilds the whole tree, the static
    leaves included: each inexact leaf becomes the matching slice of
    ``vec``, reshaped and cast to the leaf's own dtype (a python float
    stays in ``vec``'s dtype); a module comes back as a :func:`_module_map`
    copy whose parameter slots hold those slices, never rebuilt through
    its constructor, so a tangent or a gradient on ``vec`` reaches it
    (under :mod:`torch.func` transforms too).  The flat layout is the leaf
    order of :func:`tree_leaves`.
    """
    dynamic, static = partition(tree)
    leaves = tree_leaves(dynamic)
    leaves = [torch.from_numpy(np.array(x)) if isinstance(x, (np.ndarray, np.generic)) else x
              for x in leaves]
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    dtype = functools.reduce(torch.promote_types, [x.dtype for x in tensors]) if tensors \
        else torch.get_default_dtype()
    device = tensors[0].device if tensors else None
    specs = []                      # (shape, dtype; None for a python number)
    parts = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            specs.append((tuple(x.shape), x.dtype))
            parts.append(x.detach().reshape(-1).to(device=device, dtype=dtype))
        else:
            specs.append(((), None))
            parts.append(torch.tensor([x], dtype=dtype, device=device))
    flat = torch.cat(parts) if parts else torch.zeros((0,), dtype=dtype, device=device)

    def unravel(vec: torch.Tensor):
        it = iter(specs)
        offset = 0

        def take(x):
            nonlocal offset
            if x is None:
                return None
            shape, leaf_dtype = next(it)
            n = int(np.prod(shape, dtype=np.int64))
            piece = vec[offset:offset + n].reshape(shape)
            offset += n
            return piece if leaf_dtype is None else piece.to(leaf_dtype)

        return combine(tree_map(take, dynamic), static)

    return flat, unravel
