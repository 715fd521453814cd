"""Logical-axis -> PartitionSpec resolution and the ambient-mesh context
(counterpart of ``repro.dist.sharding``).

The model layer names every parameter/activation dimension with a *logical*
axis ("batch", "ffn", "kv_seq", ...).  :func:`resolve_spec` maps one logical
axes tuple onto mesh axes via :data:`DEFAULT_RULES`:

* each rule lists *candidate* mesh-axis groups in preference order -- e.g.
  batch prefers the combined ("pod", "data") group when a pod axis exists,
  falling back to "data" alone;
* a candidate binds only if every mesh axis in it exists, is still unused
  for this array, and the product of the axis sizes divides the dimension;
  otherwise the next candidate is tried, and finally the dim is replicated;
* low-priority rules (kv_seq) resolve after everything else, so they pick up
  *idle* axes (context parallelism) without stealing "model" from heads.

:func:`zero_fragment` adds the ZeRO extension: the largest replicated dim of
an (already resolved) spec is sharded over the mesh axes the spec leaves
unused, when divisible.

The module is pure Python.  A mesh is anything with ``.shape``, an ordered
name -> size mapping (``launch.mesh.Mesh``, or a duck-typed fake), as in
the reference.  :class:`PartitionSpec` and :class:`NamedSharding` are the
port's own: torch has no sharding types, and JAX's are not imported.

The ambient mesh (:func:`use_mesh` / :func:`current_mesh`) is what
``models.common.constrain`` consults; outside any mesh context constraints
are free no-ops.  Unlike the reference's, :func:`current_mesh` has no
fallback to a framework's ambient mesh (torch has none), and
:func:`use_mesh` enters no framework context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence


class PartitionSpec(tuple):
    """One entry per array dimension: ``None`` (replicated), a mesh-axis
    name, or a tuple of names (sharded over their product).

    Entries are canonicalized as JAX's are: a list becomes a tuple, an
    empty tuple or ``(None,)`` becomes ``None``, and a one-name tuple
    becomes the name.  Any other entry raises ``TypeError``.
    """

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __getnewargs__(self):  # copy and pickle rebuild it entry by entry
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _canonical(entry):
    if entry is None or isinstance(entry, str):
        return entry
    if isinstance(entry, (tuple, list)):
        names = tuple(entry)
        if names in ((), (None,)):
            return None
        if not all(isinstance(n, str) for n in names):
            raise TypeError(f"PartitionSpec entry {entry!r}: a tuple of "
                            f"mesh-axis names is expected")
        return names[0] if len(names) == 1 else names
    raise TypeError(f"PartitionSpec entry {entry!r}: None, a mesh-axis name "
                    f"or a tuple of names is expected")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` bound to a mesh.  Nothing is placed: one process
    holds every array whole; the sharding says what one device of ``mesh``
    would hold (:meth:`shard_shape`)."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """Each dimension divided by the product of its axes' sizes;
        ``ValueError`` where that product does not divide it (as JAX's)."""
        axes = _mesh_axes(self.mesh)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than the shape "
                             f"{tuple(global_shape)} has dimensions")
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n = math.prod(axes[a] for a in names)
            if dim % n:
                raise ValueError(
                    f"{self.spec} partitions array axis {i} {n} times, but "
                    f"the dimension size is {dim} (full shape: "
                    f"{tuple(global_shape)})")
            out.append(dim // n)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Rule:
    """Sharding preference for one logical axis name.

    ``candidates`` are tried in order; each is a tuple of mesh-axis names
    that must all be present, unused, and whose combined size must divide
    the dimension.  ``priority`` orders resolution across dims of one array
    (lower resolves first); scavenger axes like kv_seq use a high value so
    they only claim mesh axes nothing else wanted.
    """

    candidates: tuple[tuple[str, ...], ...]
    priority: int = 0


DEFAULT_RULES: dict[str, Rule] = {
    "batch": Rule((("pod", "data"), ("data",))),
    "vocab": Rule((("model",),)),
    "heads": Rule((("model",),)),
    "kv_heads": Rule((("model",),)),
    "ffn": Rule((("model",),)),
    "experts": Rule((("part",), ("model",))),
    # banked-IRU bank rows: the leading [n_partitions, ...] dim of the
    # engine's partition-major buffers (and the MoE expert-parallel
    # capacity buffer) shards over the IRU mesh's "part" axis
    "iru_part": Rule((("part",),)),
    # edge-partitioned graph shards: the leading [n_parts, ...] dim of
    # GraphPartition's stacked per-shard arrays shards one graph shard per
    # device over the graph mesh's "gpart" axis (launch.mesh.make_graph_mesh)
    "graph_part": Rule((("gpart",),)),
    "moe_ffn": Rule((("model",),)),
    "ssm_heads": Rule((("model",),)),
    # context parallelism: scavenges whatever the other dims left idle
    "kv_seq": Rule((("data", "model"), ("model",), ("data",)), priority=1),
}


def _mesh_axes(mesh) -> dict:
    # the port's Mesh and duck-typed fakes both expose .shape, name -> size
    return dict(mesh.shape)


def _candidate_size(cand: Sequence[str], axes: dict) -> Optional[int]:
    size = 1
    for a in cand:
        if a not in axes:
            return None
        size *= axes[a]
    return size


def resolve_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh) -> PartitionSpec:
    """Resolve one array's logical axes tuple to a PartitionSpec on ``mesh``."""
    axes = _mesh_axes(mesh)
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    entries: list = [None] * len(shape)
    used: set[str] = set()

    order = sorted(
        range(len(shape)),
        key=lambda i: (DEFAULT_RULES[logical_axes[i]].priority
                       if logical_axes[i] in DEFAULT_RULES else 0, i),
    )
    for i in order:
        name = logical_axes[i]
        rule = DEFAULT_RULES.get(name) if name is not None else None
        if rule is None:
            continue
        for cand in rule.candidates:
            cand = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used for a in cand):
                continue
            size = _candidate_size(cand, axes)
            if size is None or size <= 1 or shape[i] % size != 0:
                continue
            entries[i] = cand[0] if len(cand) == 1 else cand
            used.update(cand)
            break
    return P(*entries)


def zero_fragment(spec: PartitionSpec, shape: Sequence[int],
                  mesh) -> PartitionSpec:
    """ZeRO-style extension: shard the largest replicated dim over idle axes.

    Optimizer moments / error-feedback buffers mirror the param spec; this
    fragments their replicated remainder across the mesh axes the spec does
    not already occupy (combined group first, then single axes by size).
    Returns the spec unchanged when nothing divides.
    """
    axes = _mesh_axes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set[str] = set()
    for e in entries:
        if e is None:
            continue
        used.update((e,) if isinstance(e, str) else e)
    idle = [a for a in axes if a not in used]
    if not idle:
        return spec
    candidates: list[tuple[str, ...]] = []
    if len(idle) > 1:
        candidates.append(tuple(idle))
    candidates.extend((a,) for a in sorted(idle, key=lambda a: -axes[a]))

    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[i] is not None:
            continue
        for cand in candidates:
            size = _candidate_size(cand, axes)
            if size is None or size <= 1 or shape[i] % size != 0:
                continue
            entries[i] = cand[0] if len(cand) == 1 else cand
            return P(*entries)
    return spec


# ---------------------------------------------------------------------------
# Ambient mesh context (what models.common.constrain binds against)
# ---------------------------------------------------------------------------

_STATE = threading.local()


def current_mesh():
    """The mesh installed by :func:`use_mesh`, else None."""
    return getattr(_STATE, "mesh", None)


def constraints_enabled() -> bool:
    return getattr(_STATE, "constraints", True)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


@contextlib.contextmanager
def no_constraints():
    """Disable activation sharding constraints (lowering experiments)."""
    prev = constraints_enabled()
    _STATE.constraints = False
    try:
        yield
    finally:
        _STATE.constraints = prev
