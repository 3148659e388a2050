"""Checkpoint / resume (PyTorch port of :mod:`pde_opt_tpu.utils.checkpoint`).

The JAX package saves the full pytree (parameters, optimizer state, the env
state batch, PRNG keys) with orbax; the port keeps its own format, one file
a step:

* ``<directory>/ckpt_<step>.pt``, written with :func:`torch.save` to a
  temporary name and then renamed, so a reader never sees half a file;
* inside, ``{"format": 1, "tree": skeleton, "leaves": {path: leaf}}``: the
  tree's leaves by path (``"params/w"``, ``"opt/state/0/exp_avg"``), each a
  tensor (a numpy array is saved as one), a python number, a string or
  ``None``, and the tree's dicts, lists and tuples with each leaf replaced
  by its path (a NamedTuple, such as an ``EnvState``, by a dict of its
  fields);
* read back with ``torch.load(weights_only=True)``: nothing of a caller's
  class is pickled or run.

A tensor is saved on its device and comes back there, unless a template
puts it elsewhere.  The port's counterpart of the JAX env state's PRNG keys
is the env's auto-reset generator: save ``generator.get_state()`` in the
tree and resume with ``generator.set_state(...)`` and
:meth:`~pde_opt_tpu_torch.envs.vector_env.VectorPDEEnv.set_generator`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(key, child)`` pairs of a container, else None (a leaf)."""
    if isinstance(tree, dict):
        return list(tree.items())
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _split(tree, path: str, leaves: dict):
    """The tree's skeleton, its leaves gathered by path into ``leaves``."""
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, np.ndarray | np.generic):
            tree = torch.from_numpy(np.array(tree))
        elif isinstance(tree, torch.Tensor):
            tree = tree.detach()
        elif not (tree is None or isinstance(tree, (bool, int, float, complex, str))):
            raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__} at "
                            f"{path or '/'}")
        leaves[path] = tree
        return path
    sub = {k: _split(v, f"{path}/{k}" if path else str(k), leaves) for k, v in kids}
    if isinstance(tree, dict) or _is_namedtuple(tree):
        return sub
    return type(tree)(sub.values()) if isinstance(tree, list) else tuple(sub.values())


def _build(skeleton, leaves: dict):
    """Plain nested dicts, lists and tuples from the skeleton."""
    if isinstance(skeleton, dict):
        return {k: _build(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_build(v, leaves) for v in skeleton)
    return leaves[skeleton]


def _like(template, path: str, leaves: dict):
    """The template's structure, each leaf the saved one at its path, on the
    template leaf's device and in its dtype."""
    kids = _children(template)
    if kids is None:
        if path not in leaves:
            raise KeyError(f"the checkpoint has no leaf at {path or '/'}")
        got = leaves[path]
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(got).to(device=template.device, dtype=template.dtype)
        if isinstance(template, np.ndarray | np.generic):
            return np.asarray(got.cpu().numpy() if isinstance(got, torch.Tensor) else got,
                              dtype=template.dtype)
        if isinstance(template, (bool, int, float, complex)) and isinstance(got, torch.Tensor):
            return type(template)(got.item())
        return got
    vals = {k: _like(v, f"{path}/{k}" if path else str(k), leaves) for k, v in kids}
    if isinstance(template, dict):
        return type(template)(vals)
    if _is_namedtuple(template):
        return type(template)(**vals)
    return type(template)(vals.values())


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{int(step)}.pt")


def save_checkpoint(directory: str, step: int, tree: Any, max_to_keep: int = 3) -> None:
    """Save a tree (tensors, numpy arrays, python scalars and strings in
    nested dicts, lists, tuples and NamedTuples) at ``step``; keep the
    latest ``max_to_keep`` steps and delete older ones."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    leaves: dict = {}
    skeleton = _split(tree, "", leaves)
    final = _path(directory, step)
    tmp = f"{final}.tmp{os.getpid()}"
    torch.save({"format": 1, "tree": skeleton, "leaves": leaves}, tmp)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep] if max_to_keep > 0 else []:
        os.remove(_path(directory, old))


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Any = None) -> Any:
    """Restore the tree saved at ``step`` (default: the latest).

    With ``template`` (a tree of the saved structure, e.g. the live objects
    of a fresh run) the result has the template's structure, containers'
    types included, and each tensor the template leaf's device and dtype;
    without it, plain nested dicts, lists and tuples.  Raises
    ``FileNotFoundError`` when the directory holds no checkpoint.
    """
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    saved = torch.load(_path(directory, step), weights_only=True)
    if template is not None:
        return _like(template, "", saved["leaves"])
    return _build(saved["tree"], saved["leaves"])


def latest_step(directory: str) -> Optional[int]:
    """Latest checkpoint step under ``directory`` (None if there is none)."""
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None
