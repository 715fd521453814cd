"""Measurement mode and the layer/chunk loop (counterpart of
``repro.models.measure``).

The reference's ``mscan`` is ``lax.scan``, which XLA's cost analysis counts
once per while loop; its ``measure_mode()`` fully unrolls every call site
so the dry-run sees every iteration.  Eager torch has no compiled loop:
``mscan`` here is a Python loop over the leading axis that stacks its
outputs, so every iteration always runs and is always visible to a
profiler.  ``measure_mode`` and ``measuring`` are kept so the reference's
names resolve; the flag changes nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

_MEASURE = [False]


def measuring() -> bool:
    return _MEASURE[0]


@contextlib.contextmanager
def measure_mode():
    prev = _MEASURE[0]
    _MEASURE[0] = True
    try:
        yield
    finally:
        _MEASURE[0] = prev


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts, lists, tuples and
    dataclasses; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _stack(trees: list):
    """Stack a list of same-structure trees leaf by leaf on a new axis 0."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: _stack([getattr(t, f.name)
                                              for t in trees])
                              for f in dataclasses.fields(first)})
    return torch.stack(trees)


def mscan(body, init, xs, length=None):
    """``lax.scan`` as a loop: ``body(carry, x_i) -> (carry, y_i)`` over the
    leading axis of ``xs`` (a tree of tensors, or a ``range`` of chunk
    numbers; ``None`` with ``length``); returns the last carry and the
    ``y_i`` stacked on a new leading axis."""
    n = length if length is not None else len(tree_leaves(xs)[0])
    # a leaf that requires grad is split once with ``unbind``, whose
    # backward stacks the n grads in one op; n ``a[i]`` selects would each
    # pad a zero copy of the whole leaf in the backward (O(n^2) bytes)
    cols = [a.unbind(0) if isinstance(a, torch.Tensor) and a.requires_grad
            else a for a in tree_leaves(xs)]
    carry, ys = init, []
    for i in range(n):
        it = iter([c[i] for c in cols])
        carry, y = body(carry, tree_map(lambda _: next(it), xs))
        ys.append(y)
    return carry, (_stack(ys) if ys else None)
