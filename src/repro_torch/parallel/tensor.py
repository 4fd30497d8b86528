"""Tensor parallelism over one mesh axis (``"model"``), and parameters
split over the rows of the batch axes (FSDP), under one controller.

This module is the one place that knows how a parameter dim is split over
the mesh. A *position* is one entry of the mesh's devices (a
``torch.device``, which may repeat: ``[cuda:0] * 4`` on one card, ``[cpu] *
4`` in the tests). The positions form a grid: a row for each position of the
rules' batch axes, a column for each position of the model axis. A row holds
its rows of the batch; column ``j`` holds slice ``j`` of every parameter
dim that ``logical_spec`` puts on the axis (contiguous, equal slices), and
every other leaf whole. One process drives every position, as the pipeline
engine (``exec/engine.py``) and the data-parallel step do.

Each position runs its own program, as one device of ``repro``'s SPMD
program does: the residual stream is a list with one copy a position, and a
layer runs in one of two modes.

* **split**, where ``logical_spec`` puts every leaf the split needs on the
  axis: attention, a Mamba-2 mixer, a dense MLP (a contiguous range of
  ``mlp``), an MoE layer over ``experts``, the embedding and the head over
  ``vocab``. The position computes its share from its stream copy:

  - attention from its contiguous columns of ``wq``, ``wk``, ``wv`` and
    rows of ``wo`` (``models/attention.py::head_shard``). The query heads
    form ``gcd(H, m)`` groups; where ``H`` divides, a position's columns
    are whole heads of one group, else each group is attended by every
    position holding its columns, from q's columns all-gathered, and each
    applies its ``wo`` rows to its columns of the group's output
    (qwen2-1.5b's 12 heads over 8 positions: 4 groups of 3 on 2 positions
    each). Where the ``KV`` heads divide, a position's K/V columns are the
    whole KV heads of its group; where they do not (qwen2-1.5b's 2 over 4
    or 8), the K and V columns are all-gathered and a group attends with
    its KV heads, and the decode cache holds every KV head, as
    ``cache_shardings`` leaves it whole;
  - a Mamba-2 mixer by heads: position ``j`` holds, of each packed leaf,
    ``1 / m`` of each segment (``ssm.packed_segments``: its heads' ``z``,
    ``x`` and ``dt`` columns of ``in_proj`` and its share of ``B|C``, the
    same channels of ``conv_w``/``conv_b``), and its heads' rows of
    ``norm`` and ``out_proj`` and entries of ``A_log``, ``dt_bias``,
    ``D_skip``: exactly ``1 / m`` of each leaf, as ``repro``'s contiguous
    shard. It projects and convolves its channels, the convolved ``B|C``
    is all-gathered, it scans its heads, the gated RMSNorm's sums of
    squares are all-reduced, and its ``out_proj`` rows give its partial.
    The decode cache's SSM state is split by heads (``SSM_CACHE_AXES``)
    and its conv ring follows ``conv_w``'s channels;
  - the MLP over its columns of ``w_gate`` and ``w_up`` and rows of
    ``w_down``, its experts' products (``models/moe.py::expert_ffn``) after
    every position routed the same way from the router's logits gathered
    in shard order, its vocabulary range of the embedding (zeros
    elsewhere).

  ``reduce_partial`` sums the shares in shard order, in f32, and each
  position takes a copy. The head's logit columns are gathered in shard
  order before the CE, which stays ``repro``'s.
* **gathered**, where ``logical_spec`` replicates a leaf the split needs
  (rules that take a dim off the axis, or a dim that does not divide): the
  layer's split leaves are gathered in shard order (an all-gather) and
  every position computes the whole layer, as a replicated layer runs; so
  do leaves that other rules put on the axis outside these patterns (norms
  with ``embed`` on the axis), and attention whose head groups would span
  part of two KV groups. A gathered layer of the decode step gathers the
  cache leaves that the axis splits before the step and writes each
  position's slice back after it.

A leaf may also be **split over the rows** (FSDP, or ZeRO-3), where
``logical_spec`` puts one of its dims on some of the batch axes (``embed``
on ``"data"``): ``Layout.row_dims`` holds that dim and its axes. The rows
that differ only on those axes form the leaf's row group (under ``("pod",
"data", "model")`` with ``embed=data``, the rows of one pod), and row ``i``
holds slice ``s`` of the dim, ``s`` its index over the axes, of its
column's slice: ``repro``'s local shard under ``param_shardings``. Before a
unit reads such a leaf, each position all-gathers the slices in shard order
from the positions of its column in its row group (``row_params`` hands a
row program the slices as ``Parts``): a period's leaves at the start of the
period, again in its checkpointed recompute, and the gathered copy is
dropped after the period; the embedding, the final norm and the head
likewise where they use it. Then the unit runs split or gathered as above.

The gradient of a split leaf is summed over the rows (``all_reduce``); that
of a leaf every position holds whole is summed over every position, since
each position's backward gives the share that flowed through its program.
That of a leaf split over the rows is reduce-scattered (``reduce_scatter``):
each slice sums what every row's program gave every copy of it. AdamW
updates each position's leaves in place, once a tensor where positions
share one (a replicated leaf on a repeated device); the moments follow the
parameters' layout (``shard_state``). Clipping takes the global norm over
the shards, each distinct slice once.

Each collective records its op and payload bytes, a participating position,
in the counter that ``collectives()`` makes active; ``core/step_analysis.py``
reads it and attributes compute to the position that ``at`` names.
"""
from __future__ import annotations

from collections import defaultdict
import contextlib
import functools
import dataclasses
from dataclasses import dataclass
import math
import threading

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import cross_entropy, mlp_hidden, rms_norm
from repro_torch.optim.adam import from_leaves, leaves
from repro_torch.parallel.sfb_dense import allreduce_grad
from repro_torch.parallel.sharding import AxisRules, axis_rules, logical_spec

_STATE = threading.local()

# the leaves a split layer needs on the axis, and the dim of each (of the
# leaf of one period); any other layout of the unit's leaves runs gathered
_ATTN_SPLIT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}
_MLP_SPLIT = {"w_gate": 1, "w_up": 1, "w_down": 0}
_MOE_SPLIT = {"router": 1, "w_gate": 0, "w_up": 0, "w_down": 0}
_SSM_SPLIT = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "A_log": 0, "dt_bias": 0,
              "D_skip": 0, "norm": 0, "out_proj": 0}


# ------------------------------------------------------------- positions

@contextlib.contextmanager
def at(row: int, col: int | None = None):
    """Inside, compute runs for position ``(row, col)`` of the grid; ``col``
    None is every position of the row."""
    prev = getattr(_STATE, "pos", None)
    _STATE.pos = (row, col)
    try:
        yield
    finally:
        _STATE.pos = prev


def current_position():
    """The ``(row, col)`` that ``at`` set, or None."""
    return getattr(_STATE, "pos", None)


def set_position(key) -> None:
    """Make ``key`` the current position until the next ``at`` or
    ``set_position`` (``core.step_analysis`` sets each autograd node's
    position so as the backward pass runs it)."""
    _STATE.pos = key


class Collectives:
    """Op name -> [count, payload bytes] a position, as the helpers below
    record them: a collective adds to every position that takes part."""

    def __init__(self):
        self.tally = defaultdict(lambda: defaultdict(lambda: [0, 0]))

    def record(self, op: str, nbytes: int, positions):
        for p in positions:
            e = self.tally[p][op]
            e[0] += 1
            e[1] += nbytes

    def of(self, position: int = 0) -> dict:
        """{op: (count, bytes)} of one position."""
        return {op: tuple(v) for op, v in self.tally[position].items()}


@contextlib.contextmanager
def collectives():
    """Inside, every collective helper records into the yielded counter."""
    prev = getattr(_STATE, "coll", None)
    _STATE.coll = Collectives()
    try:
        yield _STATE.coll
    finally:
        _STATE.coll = prev


@contextlib.contextmanager
def stand_in_rows(n: int):
    """Inside, the grid's one traced row stands for ``n`` rows of the batch
    axes (``launch/dryrun.py``): a gradient sum over the rows is recorded
    with ``n`` participants."""
    prev = getattr(_STATE, "rows", 1)
    _STATE.rows = n
    try:
        yield
    finally:
        _STATE.rows = prev


def _record(op: str, nbytes: int, positions, participants: int | None = None):
    c = getattr(_STATE, "coll", None)
    if c is not None and (participants or len(positions)) > 1:
        c.record(op, int(nbytes), positions)


def all_gather(parts: list, dim: int, devices, positions, to: int | None = None):
    """Concatenate ``parts`` (one a position) along ``dim`` in shard order: a
    copy on each position's device, or only position ``to``'s."""
    full_bytes = sum(p.numel() for p in parts) * parts[0].element_size()
    _record("all-gather", full_bytes, positions)
    if to is not None:
        return torch.cat([p.to(devices[to]) for p in parts], dim)
    return [torch.cat([p.to(d) for p in parts], dim) for d in devices]


def reduce_partial(parts: list, devices, positions) -> list:
    """Sum the positions' partial results in shard order, in f32, cast back
    to their dtype; a copy on each position's device (an all-reduce)."""
    _record("all-reduce", parts[0].numel() * 4, positions)
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(acc.device).float()
    acc = acc.to(parts[0].dtype)
    return [acc.to(d) for d in devices]


def all_reduce(parts: list, positions, participants: int | None = None,
               out: int | None = None):
    """The gradient sum, a copy on each part's device, or only part
    ``out``'s (``parallel.sfb_dense.allreduce_grad``); ``participants``
    counts the positions where stand-ins take part too."""
    _record("all-reduce", parts[0].numel() * parts[0].element_size(), list(positions),
            participants)
    return allreduce_grad(parts, out)


def reduce_scatter(slices: list, n: int, positions, participants: int) -> list:
    """The gradient of a leaf split over the rows into ``n`` slices: for
    each of ``slices`` (a list of what each row's program gave a copy of
    one slice), their sum on the first one's device. Records the whole
    leaf's bytes, ``n`` slices', on each of ``positions``."""
    first = slices[0][0]
    _record("reduce-scatter", first.numel() * first.element_size() * n, list(positions),
            participants)
    return [allreduce_grad(parts, 0) for parts in slices]


# ---------------------------------------------------------------- layout

@dataclass(frozen=True)
class RowSplit:
    """A leaf's dim split over batch axes ``axes`` into ``n`` slices."""
    dim: int
    axes: tuple
    n: int


@dataclass(frozen=True)
class Parts:
    """A leaf split over the rows, as a row program receives it: its slices
    in shard order, held by the positions of its row group (or, in a traced
    row standing for others, copies of its own), joined along ``dim``."""
    parts: tuple
    dim: int


@dataclass(frozen=True)
class Row:
    """One row of the grid: its index, devices and flat position indices."""
    i: int
    devices: tuple
    positions: tuple


@dataclass
class Layout:
    """How ``cfg``'s parameters lie over ``rules``' mesh: ``grid`` (rows over
    the batch axes, columns over ``axis``), ``dims`` (a tree like the
    parameters: the dim of each leaf split over ``axis``, or None),
    ``row_dims`` (a tree like ``dims``: each leaf's ``RowSplit`` over batch
    axes, or None), ``modes`` ("split" or "gathered" for each unit:
    ``embed``, ``head`` and ``layer{j}/mixer``, ``layer{j}/ffn``) and
    ``segments`` (a tree like ``dims``: where a position's slice of a leaf
    is ``1 / m`` of each of several segments of the split dim, their widths,
    else None). ``row_sizes`` holds the batch axes' sizes; in a traced row
    that stands for a larger mesh (``Mesh.stands_for``), that mesh's."""
    cfg: object
    rules: AxisRules
    axis: str | None
    grid: np.ndarray
    dims: dict
    modes: dict
    segments: dict | None = None
    row_dims: dict | None = None
    row_sizes: dict | None = None

    @property
    def n(self) -> int:
        return self.grid.shape[0]

    @property
    def m(self) -> int:
        return self.grid.shape[1]

    @property
    def sharded(self) -> bool:
        """Whether the steps take one tree a position (``shard_params``):
        parameters split over ``axis`` or over the rows."""
        return self.m > 1 or any(r is not None for r in leaves(self.row_dims))

    def rows(self) -> list:
        return [Row(i, tuple(self.grid[i]), tuple(range(i * self.m, (i + 1) * self.m)))
                for i in range(self.n)]

    @functools.cached_property
    def period_dims(self) -> dict:
        """``dims`` of one period's leaves (the stacked dim taken off)."""
        return _map_dims(self.dims["blocks"], lambda d: None if d is None else d - 1)

    def _coords(self, i: int) -> dict:
        """Row ``i``'s index on each batch axis (the traced row's: 0)."""
        names = list(self.row_sizes)
        traced = [self.rules.mesh.shape[a] for a in names]
        return dict(zip(names, (int(c) for c in np.unravel_index(i, traced))))

    def row_slice(self, i: int, split: RowSplit) -> int:
        """The slice of ``split``'s dim that row ``i`` holds."""
        c = self._coords(i)
        return int(np.ravel_multi_index([c[a] for a in split.axes],
                                        [self.row_sizes[a] for a in split.axes]))

    def holders(self, p: int, split: RowSplit) -> list:
        """The positions that hold the slices position ``p`` gathers, in
        shard order: its column's in its row group. A traced row standing
        for others holds every slice's place itself."""
        i, j = divmod(p, self.m)
        c = self._coords(i)
        out = {}
        for r in range(self.n):
            cr = self._coords(r)
            if all(cr[a] == c[a] for a in c if a not in split.axes):
                out.setdefault(self.row_slice(r, split), r * self.m + j)
        return [out.get(s, p) for s in range(split.n)]

    def first_holders(self) -> list:
        """For each leaf (``leaves`` order), the first position that holds
        each of its distinct shards."""
        out = []
        for d, r in zip(leaves(self.dims), leaves(self.row_dims), strict=True):
            seen, firsts = set(), []
            for p in range(self.grid.size):
                key = (None if d is None else p % self.m,
                       None if r is None else self.row_slice(p // self.m, r))
                if key not in seen:
                    seen.add(key)
                    firsts.append(p)
            out.append(firsts)
        return out


def _map_dims(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_dims(v, fn) for k, v in tree.items()}
    return fn(tree)


def _batch_axes(rules) -> tuple:
    ax = rules.mesh_axes("batch") or ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def layout(cfg, rules: AxisRules | None) -> Layout | None:
    """The layout of ``cfg`` under ``rules``; None for one device (no rules,
    or a mesh of one). ``axis`` is the one mesh axis outside the batch axes
    with more than one position (None: ``m`` 1). A parameter dim on batch
    axes splits over the rows (``row_dims``). Raises NotImplementedError
    where two axes outside the batch axes have more than one position, or
    where a parameter dim names axes of more than one position that are
    neither ``axis`` nor batch axes alone (``axis`` with a batch axis, or a
    second model axis) or a second dim of a leaf names batch axes, and
    TypeError where ``rules`` is no ``AxisRules``."""
    if rules is not None and not isinstance(rules, AxisRules):
        raise TypeError(f"rules must be AxisRules or None, got {type(rules).__name__}")
    if rules is None or rules.mesh is None or rules.mesh.size == 1:
        return None
    mesh = rules.mesh
    # a traced row's parameters lie as on the mesh it stands for
    full = rules if mesh.stands_for is None else dataclasses.replace(rules,
                                                                     mesh=mesh.stands_for)
    bax = _batch_axes(rules)
    rest = [a for a in mesh.axis_names if a not in bax]
    tp = [a for a in rest if mesh.shape[a] > 1]
    if len(tp) > 1:
        raise NotImplementedError(f"rules over {mesh.shape} need parameters split over "
                                  f"{tp}: the step splits them over one axis")
    axis = tp[0] if tp else None
    abstract, axes = model_mod.abstract_params(cfg), model_mod.param_axes(cfg)
    sizes = full.mesh.shape

    def dims_of(ax, t):
        with axis_rules(full):
            spec = logical_spec(ax, shape=tuple(t.shape))
        col, row = None, None
        for d, e in enumerate(spec):
            if e is None:
                continue
            names = e if isinstance(e, tuple) else (e,)
            if all(sizes[a] == 1 for a in names):
                continue
            if e == axis:
                col = d
            elif row is None and all(a in bax for a in names):
                row = RowSplit(d, names, int(np.prod([sizes[a] for a in names])))
            else:
                raise NotImplementedError(
                    f"a parameter dim of shape {tuple(t.shape)} (axes {ax}) lies on mesh axes "
                    f"{e!r} of {mesh.shape}: the step cannot split parameters there")
        return col, row

    def walk(ax, t):
        if isinstance(ax, dict):
            return {k: walk(ax[k], t[k]) for k in ax}
        return dims_of(ax, t)
    both = walk(axes, abstract)
    dims = _map_dims(both, lambda cr: cr[0])
    row_dims = _map_dims(both, lambda cr: cr[1])
    order = [mesh.axis_names.index(a) for a in (*bax, *(a for a in rest if a != axis),
                                                 *((axis,) if axis else ()))]
    grid = np.transpose(mesh.devices, order).reshape(-1, mesh.shape[axis] if axis else 1)
    lay = Layout(cfg, rules, axis, grid, dims, {}, row_dims=row_dims,
                 row_sizes={a: sizes[a] for a in bax})
    lay.modes = _modes(lay)
    lay.segments = _map_dims(dims, lambda d: None)
    for j, ch in enumerate(cfg.pattern):
        if ch == "M" and lay.modes[f"layer{j}/mixer"] == "split":
            lay.segments["blocks"][f"layer{j}"]["mixer"].update(ssm_mod.packed_segments(cfg))
    return lay


def _fits(dims: dict, want: dict) -> bool:
    return all(dims[k] == want[k] for k in dims)


def _modes(lay: Layout) -> dict:
    cfg, m = lay.cfg, lay.m
    modes = {}
    pd = lay.period_dims
    for j, ch in enumerate(cfg.pattern):
        mix = pd[f"layer{j}"]["mixer"]
        if ch == "A":
            # each position's group of query heads within one KV group or
            # over whole ones (attention.head_shard)
            n, G = cfg.num_heads // math.gcd(cfg.num_heads, m), cfg.num_heads // cfg.num_kv_heads
            split = _fits(mix, _ATTN_SPLIT) and (n % G == 0 or G % n == 0)
        else:
            # every leaf on the axis: nheads, d_inner and 2 g ds divide
            split = _fits(mix, _SSM_SPLIT)
        modes[f"layer{j}/mixer"] = "split" if m > 1 and split else "gathered"
        if cfg.d_ff > 0:
            ffn = pd[f"layer{j}"]["ffn"]
            want = _MOE_SPLIT if tf_mod._layer_is_moe(cfg, j) else _MLP_SPLIT
            modes[f"layer{j}/ffn"] = "split" if m > 1 and _fits(ffn, want) else "gathered"
    modes["embed"] = "split" if m > 1 and lay.dims["embed"] == 0 else "gathered"
    head = lay.dims["embed"] == 0 if cfg.tie_embeddings else lay.dims["head"] == 1
    modes["head"] = "split" if m > 1 and head else "gathered"
    return modes


def describe(lay: Layout) -> str:
    """The units that run gathered, the leaves split over the rows, and the
    heads a position of a split attention layer attends, as one line."""
    cfg, m = lay.cfg, lay.m
    gathered = sorted(k for k, v in lay.modes.items() if v == "gathered")
    out = f"{m} positions on {lay.axis!r}; gathered: {gathered or 'none'}"
    split = [r for r in leaves(lay.row_dims) if r is not None]
    if split:
        over = sorted({"+".join(r.axes) + f" ({r.n})" for r in split})
        out += f"; {len(split)} leaves split over the rows: {', '.join(over)}"
    if any(ch == "A" and lay.modes[f"layer{j}/mixer"] == "split"
           for j, ch in enumerate(cfg.pattern)):
        sh = attn.head_shard(cfg, m, 0)
        r = m // math.gcd(cfg.num_heads, m)
        out += (f"; attention: {sh.cfg.num_heads} query heads on {sh.cfg.num_kv_heads} KV heads "
                f"a position" + (f", each group's on {r} positions" if r > 1 else "")
                + (", KV heads by group" if sh.kv is not None else ""))
    return out


# ------------------------------------------------------- shards of a tree

def _slice(t, dim: int | None, j: int, m: int, segments=None):
    """Position ``j``'s slice of ``t``: the ``j``-th of ``m`` equal ranges of
    ``dim``, or of each segment of it, concatenated."""
    if dim is None:
        return t
    if segments is None:
        w = t.shape[dim] // m
        return t.narrow(dim, j * w, w)
    parts, off = [], 0
    for n in segments:
        parts.append(t.narrow(dim, off + j * (n // m), n // m))
        off += n
    return torch.cat(parts, dim)


def _join(parts: list, dim: int, segments=None):
    """The inverse of ``_slice``: the leaf from its positions' slices."""
    if segments is None:
        return torch.cat(parts, dim)
    m, out, off = len(parts), [], 0
    for n in segments:
        out += [p.narrow(dim, off, n // m) for p in parts]
        off += n // m
    return torch.cat(out, dim)


def _shard(lay: Layout, tree, dims, segs, rows) -> list:
    """One tree a position (flat grid order) of ``tree``'s slices; a slice
    moves to the position's device, so positions on one device share it."""
    if isinstance(tree, dict):
        per = {k: _shard(lay, tree[k], dims[k], segs[k], rows[k]) for k in tree}
        return [{k: v[p] for k, v in per.items()} for p in range(lay.grid.size)]
    cols = [_slice(tree, dims, j, lay.m, segs) for j in range(lay.m)]
    # a row slice is cut once a (column slice, slice), so that positions
    # that hold the same one share it
    cut = {}

    def piece(i, j):
        c = cols[j] if dims is not None else cols[0]
        if rows is None:
            return c
        key = (j if dims is not None else None, lay.row_slice(i, rows))
        if key not in cut:
            cut[key] = _slice(c, rows.dim, key[1], rows.n)
        return cut[key]
    return [piece(i, j).to(lay.grid[i, j]) for i in range(lay.n) for j in range(lay.m)]


def shard_params(cfg, params, rules: AxisRules) -> list:
    """Each position's slice of every leaf of ``params``, as ``logical_spec``
    gives it: a list of trees in flat grid order (rows over the batch axes,
    then the model axis), each leaf ``repro``'s local shard under
    ``param_shardings``. A contiguous slice is a view where the position's
    device is the leaf's, and a replicated leaf is the leaf itself there;
    the slice of a packed leaf of a split Mamba-2 mixer (``segments``) is a
    copy of ``1 / m`` of the leaf. A leaf split over the rows gives row
    ``i`` its slice of the dim (``Layout.row_slice``)."""
    lay = layout(cfg, rules)
    return _shard(lay, params, lay.dims, lay.segments, lay.row_dims)


def shard_state(cfg, state: dict, rules: AxisRules) -> dict:
    """AdamW's moments ``{"mu", "nu"}`` laid out as ``shard_params`` lays out
    the parameters."""
    return {k: shard_params(cfg, v, rules) for k, v in state.items()}


def gather_params(cfg, shards: list, rules: AxisRules):
    """The inverse of ``shard_params``: every leaf whole, on the first
    position's device, each column's row slices joined in shard order (from
    row 0's row group), then the columns of row 0."""
    lay = layout(cfg, rules)
    dev = lay.grid[0, 0]

    def rec(nodes, dims, segs, rows):
        if isinstance(nodes[0], dict):
            return {k: rec([t[k] for t in nodes], dims[k], segs[k], rows[k])
                    for k in nodes[0]}
        cols = [nodes[j] if rows is None else
                torch.cat([nodes[q].to(dev) for q in lay.holders(j, rows)], rows.dim)
                for j in range(lay.m)]
        if dims is None:
            return cols[0].to(dev)
        return _join([t.to(dev) for t in cols], dims, segs)
    return rec(shards, lay.dims, lay.segments, lay.row_dims)


def row_params(lay: Layout, shards: list, row: Row) -> list:
    """The trees a row's programs take, one a position of ``row``: its own
    leaves, and each leaf split over the rows as the ``Parts`` it gathers
    (``holders``)."""
    flat = [leaves(t) for t in shards]
    out = []
    for p in row.positions:
        mine = [t if r is None else Parts(tuple(flat[q][k] for q in lay.holders(p, r)), r.dim)
                for k, (t, r) in enumerate(zip(flat[p], leaves(lay.row_dims), strict=True))]
        out.append(from_leaves(shards[p], mine))
    return out


def row_reads(lay: Layout, i: int) -> list:
    """The ``(position, leaf)`` pairs that row ``i``'s programs read
    (``row_params``): every leaf of its positions, then the slices of
    other rows that it gathers, each once."""
    n_leaf = len(leaves(lay.dims))
    out = [(p, k) for p in range(i * lay.m, (i + 1) * lay.m) for k in range(n_leaf)]
    seen = set(out)
    for p in range(i * lay.m, (i + 1) * lay.m):
        for k, r in enumerate(leaves(lay.row_dims)):
            for q in ([] if r is None else lay.holders(p, r)):
                if (q, k) not in seen:
                    seen.add((q, k))
                    out.append((q, k))
    return out


def _whole_rows(tree, row: Row, j: int):
    """Position ``j`` of ``row``'s tree with every ``Parts`` all-gathered in
    shard order on its device."""
    if isinstance(tree, dict):
        return {k: _whole_rows(v, row, j) for k, v in tree.items()}
    if not isinstance(tree, Parts):
        return tree
    nbytes = sum(p.numel() for p in tree.parts) * tree.parts[0].element_size()
    _record("all-gather", nbytes, [row.positions[j]], len(tree.parts))
    with at(row.i, j):
        return torch.cat([p.to(row.devices[j]) for p in tree.parts], tree.dim)


def _rows_joined(row: Row, trees: list) -> list:
    return [_whole_rows(t, row, j) for j, t in enumerate(trees)]


def _periods(tree) -> list:
    """``unstack_tree`` of a tree that may hold ``Parts``."""
    if isinstance(tree, Parts):
        per = [p.unbind(0) for p in tree.parts]
        return [Parts(tuple(ps), tree.dim - 1) for ps in zip(*per, strict=True)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    per = {k: _periods(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _period_of(tree, i: int):
    """``index_tree`` of a tree that may hold ``Parts``."""
    if isinstance(tree, Parts):
        return Parts(tuple(p[i] for p in tree.parts), tree.dim - 1)
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _period_of(v, i) for k, v in tree.items()}


# ------------------------------------------------- the programs of a row

def _each(row: Row, fn, *per_position) -> list:
    """``fn`` at each position of ``row``, on the position's arguments."""
    out = []
    for j, args in enumerate(zip(*per_position, strict=True)):
        with at(row.i, j):
            out.append(fn(*args))
    return out


def _gather_leaf(row: Row, parts: list, dim, to: int | None = None):
    """A leaf whole at each position (or at ``to``): gathered where split."""
    if dim is None:
        return parts if to is None else parts[to]
    return all_gather(parts, dim, row.devices, row.positions, to)


def _closing(row: Row, pre, key: str, units: list, *per_position) -> list:
    """``pre(unit, *args) @ unit[key]`` at each position. Where this is the
    period's last unit (``_period`` sets ``last_unit``), the products of every position but
    the row's last are kept for the backward pass (``_remat_policy``): a
    checkpoint's recompute runs up to the last tensor the backward pass
    saved, so it would otherwise recompute them for the sake of the later
    positions' work, which ``repro``'s program does not."""
    last = getattr(_STATE, "last_unit", False)
    out = []
    for j, (p, *args) in enumerate(zip(units, *per_position, strict=True)):
        with at(row.i, j):
            y = pre(p, *args)
            with _flag("keep", last and j < len(units) - 1):
                out.append(y @ p[key])
    return out


@contextlib.contextmanager
def _flag(name: str, on: bool):
    prev = getattr(_STATE, name, False)
    setattr(_STATE, name, on)
    try:
        yield
    finally:
        setattr(_STATE, name, prev)


def _remat_policy(base):
    """``base`` (a ``transformer.REMAT_POLICIES`` policy, None to recompute
    everything) that also keeps the products ``_closing`` marks."""
    def policy(ctx, op, *args, **kwargs):
        if getattr(_STATE, "keep", False) and op in tf_mod._MATMULS:
            return CheckpointPolicy.MUST_SAVE
        if base is None:
            return CheckpointPolicy.PREFER_RECOMPUTE
        return base(ctx, op, *args, **kwargs)
    return policy


def _gather_unit(row: Row, units: list, dims: dict) -> list:
    full = {k: _gather_leaf(row, [u[k] for u in units], dims[k]) for k in units[0]}
    return [{k: v[j] for k, v in full.items()} for j in range(len(units))]


def _embed(lay, row, ps, batch, prefix: bool = True):
    """The stack's input on each position: (xs, pos a position, n_prefix);
    with ``prefix``, behind the projected ``batch["prefix"]`` where the
    config has a frontend, as ``model.embed_inputs``."""
    cfg = lay.cfg
    ids = [batch["tokens"].to(d) for d in row.devices]
    emb = [_whole_rows(p["embed"], row, j) for j, p in enumerate(ps)]
    if lay.modes["embed"] == "split":
        def look(w, t, j):
            V = w.shape[0]
            mine = (t >= j * V) & (t < (j + 1) * V)
            e = w[(t - j * V).clamp(0, V - 1)]
            return torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
        xs = reduce_partial(_each(row, look, emb, ids, range(lay.m)),
                            row.devices, row.positions)
    else:
        ws = _gather_leaf(row, emb, lay.dims["embed"])
        xs = _each(row, lambda w, t: w[t], ws, ids)
    xs = _each(row, lambda x: x * (cfg.d_model ** 0.5), xs)
    n_prefix = 0
    if prefix and cfg.frontend != "none":
        fp = _gather_leaf(row, [_whole_rows(p["frontend_proj"], row, j) for j, p in enumerate(ps)],
                          lay.dims["frontend_proj"])
        xs = _each(row, lambda x, w: torch.cat([batch["prefix"].to(x.device).to(x.dtype) @ w, x],
                                               dim=1), xs, fp)
        n_prefix = batch["prefix"].shape[1]
    pos = [torch.arange(xs[0].shape[1], device=d) for d in row.devices]
    return xs, pos, n_prefix


def _attn_shards(lay, row, units, hs) -> list:
    """Each position's ``(HeadShard, cols)`` of a split attention layer: the
    columns it reads from the others, all-gathered in shard order (q where
    the query heads do not divide over the axis, K and V where the KV heads
    do not)."""
    cfg, m = lay.cfg, lay.m
    shards = [attn.head_shard(cfg, m, j) for j in range(m)]
    cols = [{} for _ in range(m)]
    if shards[0].q is not None:
        qs = all_gather(_each(row, lambda p, h: attn.project_q(cfg, p, h), units, hs), -1,
                        row.devices, row.positions)
        for c, q in zip(cols, qs, strict=True):
            c["q"] = q
    if shards[0].kv is not None:
        kvs = _each(row, lambda p, h: attn.project_kv(cfg, p, h), units, hs)
        for name, i in (("k", 0), ("v", 1)):
            full = all_gather([kv[i] for kv in kvs], -1, row.devices, row.positions)
            for c, t in zip(cols, full, strict=True):
                c[name] = t
    return list(zip(shards, cols, strict=True))


def _ssm_split(lay, row, units, hs, caches=None):
    """A Mamba-2 mixer split by heads over the row's positions (the module
    docstring): the prefill, or with ``caches`` one decode step."""
    cfg, m = lay.cfg, lay.m
    if caches is None:
        ins = _each(row, lambda p, h: ssm_mod.mixer_in(cfg, p, h, m), units, hs)
    else:
        ins = _each(row, lambda p, h, c: ssm_mod.decode_in(cfg, p, h, c, m), units, hs, caches)
    bcs = all_gather([i[2] for i in ins], -1, row.devices, row.positions)
    if caches is None:
        ys = _each(row, lambda p, i, bc, j: ssm_mod.mixer_scan(cfg, p, i[1], bc, i[3], m, j)[0],
                   units, ins, bcs, range(m))
    else:
        ys = _each(row, lambda p, i, bc, c, j: ssm_mod.decode_state(cfg, p, i[1], bc, i[3], c,
                                                                    m, j),
                   units, ins, bcs, caches, range(m))
    gated = _each(row, lambda y, i: ssm_mod.gate(y, i[0]), ys, ins)
    sumsq = reduce_partial([s for _, s in gated], row.devices, row.positions)
    parts = _closing(row, lambda p, g, s: ssm_mod.mixer_norm(cfg, p, g[0], s), "out_proj",
                     units, gated, sumsq)
    return reduce_partial(parts, row.devices, row.positions)


def _mixer(lay, row, key, ch, units, dims, hs, pos):
    cfg = lay.cfg
    if lay.modes[f"{key}/mixer"] == "split":
        if ch == "M":
            return _ssm_split(lay, row, units, hs)
        parts = _each(row, lambda p, h, q, sc: attn.attention(sc[0].cfg, p, h, q, *sc)[0],
                      units, hs, pos, _attn_shards(lay, row, units, hs))
        return reduce_partial(parts, row.devices, row.positions)
    full = _gather_unit(row, units, dims)
    if ch == "A":
        return _each(row, lambda p, h, q: attn.attention(cfg, p, h, q)[0], full, hs, pos)
    return _closing(row, lambda p, h: ssm_mod.mamba_normed(cfg, p, h)[0], "out_proj", full, hs)


def _ffn(lay, row, key, j, units, dims, hs, groups):
    """Each position's FFN output and the MoE layer's route (position 0's;
    None on a dense layer)."""
    cfg = lay.cfg
    split = lay.modes[f"{key}/ffn"] == "split"
    if not tf_mod._layer_is_moe(cfg, j):
        if split:
            return reduce_partial(_closing(row, mlp_hidden, "w_down", units, hs), row.devices,
                                  row.positions), None
        return _closing(row, mlp_hidden, "w_down", _gather_unit(row, units, dims), hs), None
    if not split:
        outs = _each(row, lambda p, h: moe_mod.moe_layer(cfg, p, h, groups),
                     _gather_unit(row, units, dims), hs)
        return [y for y, _ in outs], outs[0][1]
    G, Tg, C = moe_mod.layer_capacity(cfg, hs[0], groups)
    D = hs[0].shape[-1]
    parts = _each(row, lambda p, h: (h.reshape(G, Tg, D) @ p["router"]).float(), units, hs)
    logits = all_gather(parts, -1, row.devices, row.positions)
    # every position routes alike, from the logits of every expert
    routes = _each(row, lambda lg, h: moe_mod.route_logits(cfg, lg, C, h.dtype), logits, hs)
    E_loc = cfg.num_experts // lay.m
    ys = _each(row, lambda p, h, r, jj: moe_mod.expert_ffn(cfg, p, h, r, first=jj * E_loc),
               units, hs, routes, range(lay.m))
    return reduce_partial(ys, row.devices, row.positions), routes[0]


def _period(lay, row, pps, xs, pos, groups):
    """One period of layers over the row's positions: (xs, aux, stats), as
    ``transformer.period_fwd``; ``pps`` may hold ``Parts``."""
    cfg = lay.cfg
    pd = lay.period_dims
    # the leaves split over the rows, gathered for this period (again in
    # its recompute) and dropped after it
    pps = _rows_joined(row, pps)
    aux = torch.zeros((), dtype=torch.float32, device=row.devices[0])
    stats = []
    for j, ch in enumerate(cfg.pattern):
        key = f"layer{j}"
        last = j == len(cfg.pattern) - 1
        lps, dims = [pp[key] for pp in pps], pd[key]
        g1 = _gather_leaf(row, [lp["norm1"] for lp in lps], dims["norm1"])
        hs = _each(row, lambda x, g: rms_norm(x, g, cfg.norm_eps), xs, g1)
        with _flag("last_unit", last and cfg.d_ff <= 0):
            mix = _mixer(lay, row, key, ch, [lp["mixer"] for lp in lps], dims["mixer"], hs, pos)
        xs = _each(row, torch.add, xs, mix)
        if cfg.d_ff > 0:
            g2 = _gather_leaf(row, [lp["norm2"] for lp in lps], dims["norm2"])
            hs = _each(row, lambda x, g: rms_norm(x, g, cfg.norm_eps), xs, g2)
            with _flag("last_unit", last):
                ys, r = _ffn(lay, row, key, j, [lp["ffn"] for lp in lps], dims["ffn"], hs,
                             groups)
            xs = _each(row, torch.add, xs, ys)
            if r is not None:
                aux = aux + moe_mod.aux_loss(r.density, r.mean_probs)
                stats.append((r.density, r.mean_probs))
    return xs, aux, tuple(stats)


def _stack(lay, row, blocks, xs, pos, remat: bool, remat_policy: str):
    """``transformer.stack_fwd`` over the row's positions. With ``remat``
    each period runs under one checkpoint, so that its recomputation repeats
    every position's compute and every collective of the period."""
    policy = tf_mod.REMAT_POLICIES[remat_policy]
    fn = _period
    if remat and policy != "everything":
        ctx = functools.partial(create_selective_checkpoint_contexts, _remat_policy(policy))

        def fn(lay, row, pps, xs, pos, groups):
            return checkpoint(_period, lay, row, pps, xs, pos, groups, use_reentrant=False,
                              context_fn=ctx)
    groups = moe_mod.stack_groups(xs[0].shape[0] * xs[0].shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=row.devices[0])
    stats = ()
    per = [_periods(b) for b in blocks]
    for k in range(len(per[0])):
        xs, a, st = fn(lay, row, [p[k] for p in per], xs, pos, groups)
        aux = aux + a
        stats += st
    return xs, aux, stats


def _final(lay, row, ps, xs):
    g = _gather_leaf(row, [_whole_rows(p["final_norm"], row, j) for j, p in enumerate(ps)],
                     lay.dims["final_norm"])
    return _each(row, lambda x, w: rms_norm(x, w, lay.cfg.norm_eps), xs, g)


def _logits(lay, row, ps, hs):
    """The logits on the row's first position: the head's (or the tied
    embedding's) column shards gathered in shard order, or the whole head
    there."""
    cfg = lay.cfg
    key = "embed" if cfg.tie_embeddings else "head"

    def head(h, w):
        return h @ (w.T if cfg.tie_embeddings else w)
    if lay.modes["head"] == "split":
        ws = [_whole_rows(p[key], row, j) for j, p in enumerate(ps)]
        parts = _each(row, head, hs, ws)
        return all_gather(parts, -1, row.devices, row.positions, to=0)
    if lay.dims[key] is None:
        w = _whole_rows(ps[0][key], row, 0)
    else:
        w = _gather_leaf(row, [_whole_rows(p[key], row, j) for j, p in enumerate(ps)],
                         lay.dims[key], to=0)
    with at(row.i, 0):
        return head(hs[0], w)


def loss_row(lay, row, ps, batch, *, remat=True, loss_chunk=0, remat_policy="full"):
    """``model.loss_fn`` of one row's batch over its positions' parameters
    ``ps`` (``row_params``: one tree a position): (loss, {"ce", "aux",
    "moe"}) on the row's first device."""
    if remat_policy not in tf_mod.REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                         f"known: {sorted(tf_mod.REMAT_POLICIES)}")
    xs, pos, n_prefix = _embed(lay, row, ps, batch)
    xs, aux, stats = _stack(lay, row, [p["blocks"] for p in ps], xs, pos, remat, remat_policy)
    hs = _final(lay, row, ps, xs)
    if n_prefix:
        hs = [h[:, n_prefix:] for h in hs]
    labels = batch["labels"].long().to(row.devices[0])
    S = hs[0].shape[1]
    if loss_chunk and S % loss_chunk == 0 and S > loss_chunk:
        def chunk_ce(lb, *hb):
            return cross_entropy(_logits(lay, row, ps, list(hb)), lb)

        n = S // loss_chunk
        tot = torch.zeros((), dtype=torch.float32, device=row.devices[0])
        for i in range(n):
            sl = slice(i * loss_chunk, (i + 1) * loss_chunk)
            tot = tot + checkpoint(chunk_ce, labels[:, sl], *[h[:, sl] for h in hs],
                                   use_reentrant=False)
        ce = tot / n
    else:
        ce = cross_entropy(_logits(lay, row, ps, hs), labels)
    return ce + model_mod.MAX_SMOKE_AUX * aux, {"ce": ce, "aux": aux, "moe": stats}


def prefill_row(lay, row, ps, batch):
    """``model.prefill_step`` of one row: last-position logits (B, 1, V)."""
    xs, pos, _ = _embed(lay, row, ps, batch)
    xs, _, _ = _stack(lay, row, [p["blocks"] for p in ps], xs, pos, False, "full")
    hs = _final(lay, row, ps, xs)
    return _logits(lay, row, ps, [h[:, -1:] for h in hs])


# ---------------------------------------------------------------- decode

def _cache_dims(lay: Layout, cache):
    """The dim of each cache leaf split over the axis, as ``cache_shardings``
    lays it out (or None)."""
    axes = model_mod.cache_axes(lay.cfg)

    def rec(ax, t):
        if isinstance(ax, dict):
            return {k: rec(ax[k], t[k]) for k in ax}
        with axis_rules(lay.rules):
            spec = logical_spec(ax, shape=tuple(t.shape))
        return next((d for d, e in enumerate(spec) if e == lay.axis and lay.axis), None)
    return rec(axes, cache)


def init_cache_shards(lay: Layout, rows: int, seq_len: int) -> list:
    """Each position's decode cache (flat grid order) for ``rows`` rows of a
    ``seq_len`` sequence: the leaves that ``cache_shardings`` puts on the
    axis (``kv_heads``, ``ssm_heads``, ``ssm_inner``) split, zeros on the
    position's device. The conv ring of a Mamba-2 mixer split by heads
    holds the channels of the position's ``conv_w`` (``_ssm_split``)."""
    full = model_mod.cache_specs(lay.cfg, rows, seq_len)
    dims = _cache_dims(lay, full)

    def make(t, d, dev, j):
        shape = list(t.shape)
        if d is not None:
            shape[d] //= lay.m
        return torch.zeros(shape, dtype=t.dtype, device=dev)

    def rec(t, d, dev, j):
        if isinstance(t, dict):
            return {k: rec(t[k], d[k], dev, j) for k in t}
        return make(t, d, dev, j)
    return [rec(full, dims, lay.grid[i, j], j) for i in range(lay.n) for j in range(lay.m)]


def _decode_mixer(lay, row, key, ch, units, dims, hs, caches, cdims, pos: int):
    cfg = lay.cfg
    if lay.modes[f"{key}/mixer"] == "split":
        if ch == "M":
            return _ssm_split(lay, row, units, hs, caches)
        parts = _each(row, lambda p, h, c, sc: attn.decode_attention(sc[0].cfg, p, h, c, pos,
                                                                     *sc)[0],
                      units, hs, caches, _attn_shards(lay, row, units, hs))
        return reduce_partial(parts, row.devices, row.positions)
    full = _gather_unit(row, units, dims)
    # the cache leaves the axis splits, whole on each position for the step
    whole = _gather_unit(row, caches, cdims)
    if ch == "A":
        outs = _each(row, lambda p, h, c: attn.decode_attention(cfg, p, h, c, pos)[0],
                     full, hs, whole)
    else:
        outs = _each(row, lambda p, h, c: ssm_mod.mamba_decode(cfg, p, h, c)[0], full, hs, whole)
    for j, (c, w) in enumerate(zip(caches, whole, strict=True)):
        for k, d in cdims.items():
            if d is not None:
                c[k].copy_(_slice(w[k], d, j, lay.m))
    return outs


def decode_row(lay, row, ps, caches, tokens, pos: int):
    """``model.decode_step`` of one row's tokens (B, 1) over its positions'
    parameters and caches (updated in place): logits (B, 1, V) on the row's
    first device."""
    cfg = lay.cfg
    xs, _, _ = _embed(lay, row, ps, {"tokens": tokens}, prefix=False)
    groups = moe_mod.stack_groups(xs[0].shape[0] * xs[0].shape[1])
    pd = lay.period_dims
    cd = _cache_dims(lay, model_mod.cache_specs(cfg, 1, 1))
    for i in range(cfg.num_periods):
        pps = _rows_joined(row, [_period_of(p["blocks"], i) for p in ps])
        pcs = [_period_of(c, i) for c in caches]
        for j, ch in enumerate(cfg.pattern):
            key = f"layer{j}"
            lps, dims = [pp[key] for pp in pps], pd[key]
            cdims = {k: None if d is None else d - 1 for k, d in cd[key].items()}
            g1 = _gather_leaf(row, [lp["norm1"] for lp in lps], dims["norm1"])
            hs = _each(row, lambda x, g: rms_norm(x, g, cfg.norm_eps), xs, g1)
            mix = _decode_mixer(lay, row, key, ch, [lp["mixer"] for lp in lps], dims["mixer"],
                                hs, [pc[key] for pc in pcs], cdims, pos)
            xs = _each(row, torch.add, xs, mix)
            if cfg.d_ff > 0:
                g2 = _gather_leaf(row, [lp["norm2"] for lp in lps], dims["norm2"])
                hs = _each(row, lambda x, g: rms_norm(x, g, cfg.norm_eps), xs, g2)
                ys, _ = _ffn(lay, row, key, j, [lp["ffn"] for lp in lps], dims["ffn"], hs,
                             groups)
                xs = _each(row, torch.add, xs, ys)
    return _logits(lay, row, ps, _final(lay, row, ps, xs))


# ------------------------------------------------- gradients and update

def sync_grads(lay: Layout, by_row: list, shards: list, scale: float) -> list:
    """``by_row[i]``: row ``i``'s gradients of the leaves its programs read,
    in ``row_reads`` order. A split leaf's are summed over the rows, a whole
    leaf's over every position, and a leaf split over the rows is
    reduce-scattered over its column's positions (every position where it
    is whole over the columns); each times ``scale``. Returns one tree a
    position, shaped as ``shards``."""
    got = defaultdict(list)
    for i, grads in enumerate(by_row):
        for pk, g in zip(row_reads(lay, i), grads, strict=True):
            got[pk].append(g)
    flat_dims, flat_rows = leaves(lay.dims), leaves(lay.row_dims)
    out = [[None] * len(flat_dims) for _ in shards]
    everyone = list(range(lay.grid.size))
    stand_in = getattr(_STATE, "rows", 1)
    for k, (d, r) in enumerate(zip(flat_dims, flat_rows, strict=True)):
        groups = [everyone] if d is None else [
            [i * lay.m + j for i in range(lay.n)] for j in range(lay.m)]
        for g in groups:
            if r is None:
                summed = all_reduce([got[(p, k)][0] for p in g], g, len(g) * stand_in)
                for p, t in zip(g, summed, strict=True):
                    out[p][k] = t * scale
                continue
            holding = defaultdict(list)
            for p in g:
                holding[lay.row_slice(p // lay.m, r)].append(p)
            holding = [holding[s] for s in sorted(holding)]
            sums = reduce_scatter([[t for p in ps for t in got[(p, k)]] for ps in holding],
                                  r.n, g, len(g) * stand_in)
            for ps, total in zip(holding, sums, strict=True):
                for p in ps:
                    out[p][k] = total.to(lay.grid.flat[p]) * scale
    return [from_leaves(shards[p], out[p]) for p in range(len(shards))]


def clip_by_global_norm(lay: Layout, grads: list, max_norm: float):
    """Scale every position's gradients so that their global norm, over
    each distinct shard once (``Layout.first_holders``), is at most
    ``max_norm``. Returns (grads, the norm before clipping) as
    ``optim.adam``'s."""
    dev = lay.grid[0, 0]
    flat = [leaves(t) for t in grads]
    sq = [torch.sum(flat[p][k].float() ** 2).to(dev)
          for k, firsts in enumerate(lay.first_holders()) for p in firsts]
    n = torch.sqrt(sum(sq))
    scale = torch.minimum(torch.ones_like(n),
                          torch.full_like(n, max_norm) / torch.clamp_min(n, 1e-9))
    out = []
    for tree in grads:
        ls = leaves(tree)
        s = scale.to(ls[0].device)
        out.append(from_leaves(tree, [(g.float() * s).to(g.dtype) for g in ls]))
    return out, n


def adamw_update(lay: Layout, opt, shards: list, state: dict, grads: list, step: int):
    """AdamW on every position's leaves, in place on the position's device;
    a tensor that several positions share is updated once."""
    seen = set()
    for p, tree in enumerate(shards):
        keep = [k for k, t in enumerate(leaves(tree)) if id(t) not in seen]
        seen.update(id(t) for t in leaves(tree))
        if not keep:
            continue

        def pick(t, keep=keep):
            ls = leaves(t)
            return {f"{k:06d}": ls[k] for k in keep}
        with at(p // lay.m, p % lay.m):
            opt.update(pick(tree), {"mu": pick(state["mu"][p]), "nu": pick(state["nu"][p])},
                       pick(grads[p]), step)
    return shards, state


def check_shards(lay: Layout, shards) -> None:
    """Raise TypeError unless ``shards`` is one tree a position."""
    if not isinstance(shards, list) or len(shards) != lay.grid.size:
        raise TypeError(f"with parameters split over the mesh a step takes "
                        f"parallel.tensor.shard_params(cfg, params, rules), one tree for each "
                        f"of the {lay.grid.size} positions; got {type(shards).__name__}")
