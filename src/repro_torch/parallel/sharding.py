"""Logical-axis sharding rules, the port of ``repro.parallel.sharding``.

Model code names the dims of parameters and inputs by *logical* axes
("batch", "seq", "heads", "mlp", "vocab", ...). An ``AxisRules`` maps each
logical name to mesh axes, and ``logical_spec`` turns a tuple of logical
names into a partition spec under the active rules: a mapping is dropped
where the mesh lacks the axis, where an earlier dim already took the mesh
axis, or where the mesh axis's size does not divide the dim.

The port's spec is a plain tuple, ``repro``'s ``PartitionSpec`` entry for
entry: one mesh-axis name, tuple of names or None a dim, trailing Nones
dropped, an entry of one mesh axis its name. The port's mesh is ``Mesh``
below, an array of ``torch.device``s with named axes. One controller drives
every device (``exec.engine``), so a mesh needs no process group, and
``torch.distributed.DeviceMesh``, which does, is not used.

``logical_shard`` returns its input unchanged: under one controller a
sharding constraint changes no value (the steps in ``launch/steps.py`` and
``parallel/tensor.py`` place values by their specs themselves); it exists so
that code ported from ``repro`` reads the same. ``rules_fingerprint`` is
``repro``'s signature of the active rules, ``(sorted rule items, (mesh axis
names, their sizes))``; ``launch/dryrun.py`` keys its results with it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
import threading

import numpy as np

_STATE = threading.local()


class Mesh:
    """``devices``, an array of ``torch.device``s, with one name an axis.
    A device may repeat (``[cuda:0] * 2``): one card then stands for each
    position of the mesh in turn. ``stands_for``, where set, is a larger
    mesh whose rows of the batch axes this one traces one of
    (``launch/dryrun.py``): a parameter split over those axes is laid out
    for it."""

    def __init__(self, devices, axis_names, stands_for: Mesh | None = None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.stands_for = stands_for

    @property
    def size(self) -> int:
        return self.devices.size


@dataclass
class AxisRules:
    """Mapping logical axis name -> mesh axis name (or tuple of them)."""
    mesh: Mesh | None = None
    rules: dict = field(default_factory=dict)
    # gradient sync mode a parameter-name prefix, from TAG strategies:
    #   "allreduce" (default) | "ps" | "sfb"
    grad_sync: dict = field(default_factory=dict)

    def mesh_axes(self, logical: str):
        ax = self.rules.get(logical)
        if ax is None:
            return None
        # a mapping to an axis the mesh lacks (such as "model" on the 1-D
        # host mesh) is dropped, so that one rule set serves every mesh
        present = set(self.mesh.axis_names) if self.mesh is not None else set()
        if isinstance(ax, (tuple, list)):
            ax = tuple(a for a in ax if a in present)
            return ax or None
        return ax if ax in present else None

    def axis_size(self, mesh_axis) -> int:
        if self.mesh is None:
            raise ValueError("axis_size needs rules with a mesh")
        if isinstance(mesh_axis, (tuple, list)):
            n = 1
            for a in mesh_axis:
                n *= self.mesh.shape[a]
            return n
        return self.mesh.shape[mesh_axis]


def current_rules() -> AxisRules | None:
    return getattr(_STATE, "rules", None)


def rules_fingerprint():
    """Hashable signature of the active rules, as ``repro``'s: the sorted
    rule items and the mesh's axis names and sizes; None without rules or
    mesh."""
    r = current_rules()
    if r is None or r.mesh is None:
        return None
    items = tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in r.rules.items()))
    mesh_sig = (tuple(r.mesh.axis_names),
                tuple(r.mesh.shape[a] for a in r.mesh.axis_names))
    return (items, mesh_sig)


@contextlib.contextmanager
def axis_rules(rules: AxisRules):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def logical_spec(logical_axes, shape=None) -> tuple:
    """The partition spec of the given logical axes under the current rules.

    ``logical_axes`` holds one entry (str or None) a dim. With ``shape``, a
    dim that the mesh axis's size does not divide is replicated."""
    r = current_rules()
    if r is None or r.mesh is None:
        return ()
    spec, used = [], set()
    for i, name in enumerate(logical_axes):
        ax = r.mesh_axes(name) if name is not None else None
        if ax is None:
            spec.append(None)
            continue
        key = tuple(ax) if isinstance(ax, (list, tuple)) else (ax,)
        if used & set(key):  # a mesh axis may appear only once in a spec
            spec.append(None)
            continue
        if shape is not None and shape[i] % r.axis_size(ax) != 0:
            spec.append(None)
            continue
        used |= set(key)
        # one mesh axis is its name, as PartitionSpec normalises ("data",)
        spec.append(key[0] if len(key) == 1 else key)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def logical_shard(x, *logical_axes):
    """``x`` itself: ``repro`` constrains ``x`` to the sharding of its logical
    axes, which under one controller changes no value."""
    del logical_axes
    return x


@dataclass(frozen=True)
class NamedSharding:
    """A value's layout over a mesh: ``spec`` as ``logical_spec`` gives it."""
    mesh: Mesh
    spec: tuple


def named_sharding(logical_axes, shape=None) -> NamedSharding | None:
    r = current_rules()
    if r is None or r.mesh is None:
        return None
    return NamedSharding(r.mesh, logical_spec(logical_axes, shape=shape))
