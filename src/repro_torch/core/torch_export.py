"""Graph analyzer front end: trace a PyTorch training step into TAG's
CompGraph IR (paper §4.1.1), the counterpart of ``repro.core.jax_export``.

``loss, grads = value-and-grad of loss_fn(params, batch)`` is traced with
``make_fx`` on fake tensors into an aten graph holding the forward and the
backward ops, so a full-width model is traced without computing anything.
Every aten op becomes an op node with a FLOP estimate and output bytes;
every tensor it reads becomes an edge.

Splittability (the paper's three categories) comes from propagating the
batch dimension from the data inputs, as ``jax_export`` does:
  * a batched input gives a batched output            -> Split.CONCAT
  * the batch is contracted or reduced away (dW = xᵀ dy), or transposed
                                                      -> Split.SUM
  * no batch relationship                             -> Split.OTHER
aten flattens the batch into other dims (``linear`` on (B, S, D) runs as
``view(B*S, D)`` -> ``mm`` -> ``view``), so each tensor carries the index
of the dim whose outermost factor is the batch, through views, permutes,
broadcasts, gathers and products, instead of ``jax_export``'s "dim 0 ==
batch size". The MoE dispatch gathers the batch's rows into expert slots,
so the expert products are CONCAT and their weight gradients SUM.
A linear rearrangement of partial sums over the batch (the ``stack`` of
per-layer weight gradients that ``jax_export`` sees once inside the
scanned layer body) stays Split.SUM.

aten's casts, clones, detaches and broadcasts are named after their JAX
primitives (``convert_element_type``, ``copy``, ``stop_gradient``,
``broadcast_in_dim``) with no FLOPs, so ``CompGraph.simplify`` drops them.
Gradient producers and synthetic ApplyGradient nodes are attached as in
``jax_export`` so the SFB solver can find its subgraphs.
"""
from __future__ import annotations

import math
import operator

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.graph import CompGraph, OpNode, Split

_CONTRACTIONS = {"mm", "addmm", "bmm", "baddbmm", "convolution"}
# reductions: FLOPs are the input elements; the batch may be reduced away
_REDUCERS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
             "argmin", "logsumexp", "var", "std", "var_mean", "any", "all",
             "norm", "linalg_vector_norm"}
# scatter-adds of a batched input into an unbatched buffer (embedding
# backward) reduce over the batch, as a reduction does
_SCATTER_REDUCERS = {"index_put", "index_add", "embedding_dense_backward"}
_TRANSPOSES = {"permute", "transpose", "t"}
# aten op -> the JAX primitive CompGraph.simplify drops
_TRIVIAL = {"_to_copy": "convert_element_type", "clone": "copy",
            "detach": "stop_gradient", "expand": "broadcast_in_dim"}
_ELEMWISE_EXTRA = {"_softmax_backward_data", "_log_softmax_backward_data",
                   "cumsum", "cumprod"}
# linear in their partial-sum operands: keep a sum over the batch a sum
_LINEAR = {"view", "_unsafe_view", "reshape", "alias", "permute", "transpose",
           "t", "unsqueeze", "squeeze", "expand", "slice", "select", "unbind",
           "split", "split_with_sizes", "chunk", "stack", "cat", "clone",
           "_to_copy", "detach", "add", "sub", "neg", "mul", "div", "sum",
           "mean", "slice_backward", "select_backward"}


def _flatten(tree) -> list:
    """Leaves of nested dicts in ``jax.tree.flatten``'s order: keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def go(t):
        return {k: go(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return go(tree)


def _tensors(val) -> list:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _op_name(target) -> str:
    """``aten.mm.default`` -> ``mm``."""
    return getattr(target, "_opname", None) or str(target).split(".")[-1]


def _flops(name: str, target, ins: list, outs: list) -> float:
    if not outs:
        return 0.0
    out = outs[0]
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * ins[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * ins[1].shape[-1]
    if name == "convolution":        # weight (out_c, in_c / groups, *kernel)
        return 2.0 * out.numel() * math.prod(ins[1].shape[1:])
    if name in _TRIVIAL:
        return 0.0
    if name in ("_softmax", "_log_softmax"):
        return 5.0 * ins[0].numel()
    if name in _REDUCERS:
        return float(ins[0].numel())
    if name in _ELEMWISE_EXTRA or torch.Tag.pointwise in getattr(target, "tags", ()):
        return float(out.numel())
    return 0.0


def _reshape_bdim(shape_in, b, shape_out, batch) -> int | None:
    pre = math.prod(shape_in[:b])
    for j in range(len(shape_out)):
        if math.prod(shape_out[:j]) == pre and shape_out[j] % batch == 0 \
                and shape_out[j] > 0:
            return j
        if math.prod(shape_out[:j]) > pre:
            break
    return None


def _broadcast_bdim(ins, in_b, out) -> int | None:
    R = out.dim()
    for t, b in zip(ins, in_b):
        if b is None:
            continue
        j = R - t.dim() + b
        if 0 <= j < R and out.shape[j] == t.shape[b]:
            return j
    return None


def _out_bdims(name, args, ins, in_b, outs, batch):
    """(per-output batch dim, whether the batch was contracted or reduced
    away). ``ins``/``in_b``: the tensor inputs in argument order and their
    batch dims."""
    b0 = in_b[0] if in_b else None
    x = ins[0] if ins else None
    n = len(outs)
    if name in ("view", "_unsafe_view", "reshape"):
        return [None if b0 is None else _reshape_bdim(x.shape, b0, outs[0].shape, batch)], False
    if name == "permute":
        dims = [_dim(d, x.dim()) for d in args[1]]
        return [None if b0 is None else dims.index(b0)], False
    if name in ("transpose", "t"):
        if b0 is None:
            return [None], False
        d0, d1 = (0, 1) if name == "t" or x.dim() < 2 else (_dim(args[1], x.dim()), _dim(args[2], x.dim()))
        return [d1 if b0 == d0 else d0 if b0 == d1 else b0], False
    if name == "unsqueeze":
        if b0 is None:
            return [None], False
        d = _dim(args[1], outs[0].dim())
        return [b0 + 1 if d <= b0 else b0], False
    if name == "squeeze":
        if b0 is None:
            return [None], False
        if len(args) > 1:
            ds = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            gone = {_dim(d, x.dim()) for d in ds if x.shape[_dim(d, x.dim())] == 1}
        else:
            gone = {d for d in range(x.dim()) if x.shape[d] == 1}
        return [None if b0 in gone else b0 - sum(1 for d in gone if d < b0)], False
    if name in ("expand", "alias", "clone", "_to_copy", "detach", "slice"):
        return [None if b0 is None else b0 + outs[0].dim() - x.dim()], False
    if name in ("select", "unbind"):
        d = _dim(args[1] if len(args) > 1 else 0, x.dim())
        b = None if b0 is None or d == b0 else (b0 - 1 if d < b0 else b0)
        return [b] * n, False
    if name in ("split", "split_with_sizes", "chunk"):
        return [b0] * n, False
    if name in ("cat", "stack"):
        b = next((bb for bb in in_b if bb is not None), None)
        if b is not None and name == "stack":
            d = _dim(args[1] if len(args) > 1 else 0, outs[0].dim())
            b = b + 1 if d <= b else b
        return [b], False
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        a, w = (ins[-2], ins[-1])
        ba, bw = in_b[-2], in_b[-1]
        r = a.dim()
        if ba == r - 1 or bw == r - 2:            # the batch is contracted
            return [None], True
        if ba is not None:
            return [ba], False
        if bw is not None:
            return [bw if bw == r - 1 else 0], False
        return [None], False
    if name == "convolution":
        return [b0], False
    if name in _REDUCERS:
        if b0 is None:
            return [None] * n, False
        dims = args[1] if len(args) > 1 and isinstance(args[1], (list, tuple, int)) else None
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            return [None] * n, True                  # a reduction over all dims
        dims = {_dim(d, x.dim()) for d in (dims if isinstance(dims, (list, tuple)) else [dims])}
        if b0 in dims:
            return [None] * n, True
        keep = bool(args[2]) if len(args) > 2 and isinstance(args[2], bool) else False
        b = b0 if keep else b0 - sum(1 for d in dims if d < b0)
        return [b if o.dim() else None for o in outs], False
    if name == "embedding_dense_backward":
        return [None], any(bb is not None for bb in in_b)
    if name in _SCATTER_REDUCERS and b0 is None and any(bb is not None for bb in in_b):
        return [None], True                          # added into an unbatched buffer
    if name == "index" and len(in_b) > 1 and in_b[1] is not None:
        return [in_b[1]], False
    if name == "index" and b0 == 0 and len(ins) == 2 and len(args[1]) == 1 \
            and args[1][0] is not None:
        # rows of the batch gathered into a table of slots (the MoE
        # dispatch, x[slot_token] -> (E, G*C, D)): the batch runs along the
        # table's innermost index dim, as it runs along jax_export's group
        # dim when the groups are the batch's shards
        return [ins[1].dim() - 1], False
    # pointwise and everything else: line the inputs up by broadcasting
    return [_broadcast_bdim(ins, in_b, o) if o.dim() else None for o in outs], False


class _Exporter:
    def __init__(self, batch_size: int):
        self.g = CompGraph()
        self.next_id = 0
        self.src: dict = {}        # fx node -> op_id
        self.bdim: dict = {}       # fx node -> batch dim of its value (or None)
        self.psum: dict = {}       # fx node -> value is a partial sum over the batch
        self.preds: dict = {}      # op_id -> source op_ids, one per input edge
        self.batch_size = batch_size

    def new_node(self, **kw) -> OpNode:
        node = OpNode(op_id=self.next_id, **kw)
        self.next_id += 1
        self.g.add_node(node)
        return node

    def walk(self, gm: torch.fx.GraphModule):
        for fx in gm.graph.nodes:
            if fx.op != "call_function":
                continue
            if fx.target is operator.getitem:
                parent, i = fx.args
                self.src[fx] = self.src.get(parent)
                self.bdim[fx] = self.bdim.get(parent, [None])[i] \
                    if isinstance(self.bdim.get(parent), list) else None
                self.psum[fx] = self.psum.get(parent, False)
                continue
            outs = _tensors(fx.meta.get("val"))
            if not outs:
                continue
            name = _op_name(fx.target)
            in_nodes = [a for a in torch.utils._pytree.tree_leaves((fx.args, fx.kwargs))
                        if isinstance(a, torch.fx.Node)]
            in_nodes = [a for a in in_nodes if isinstance(a.meta.get("val"), torch.Tensor)]
            ins = [a.meta["val"] for a in in_nodes]
            in_b = [self.bdim.get(a) if not isinstance(self.bdim.get(a), list) else None
                    for a in in_nodes]
            out_b, contracted = _out_bdims(name, fx.args, ins, in_b, outs, self.batch_size)
            any_in = any(b is not None for b in in_b)
            out_batched = any(b is not None for b in out_b)
            psum_in = [self.psum.get(a, False) for a in in_nodes]
            if any_in and out_batched:
                split = Split.CONCAT
            elif any_in and (name in _CONTRACTIONS or contracted):
                split = Split.SUM
            elif any_in and name in _TRANSPOSES:
                split = Split.SUM
            elif not any_in and name in _LINEAR and any(psum_in) and (
                    all(psum_in) or (name in ("mul", "div") and psum_in.count(True) == 1)):
                split = Split.SUM
            else:
                split = Split.OTHER
            node = self.new_node(
                name=f"{name}_{self.next_id}",
                op_type=_TRIVIAL.get(name, name),
                flops=_flops(name, fx.target, ins, outs),
                bytes_out=sum(_nbytes(t) for t in outs),
                split=split,
                batch_dim=out_batched,
            )
            self.preds[node.op_id] = []
            for a, t in zip(in_nodes, ins):
                s = self.src.get(a)
                if s is not None:
                    self.g.add_edge(s, node.op_id, _nbytes(t))
                    self.preds[node.op_id].append(s)
            self.src[fx] = node.op_id
            self.bdim[fx] = out_b if isinstance(fx.meta.get("val"), (list, tuple)) else out_b[0]
            self.psum[fx] = split == Split.SUM

    def producer(self, fx) -> int | None:
        """The op that computed ``fx``'s value, looking through the casts
        and copies ``simplify`` drops."""
        src = self.src.get(fx)
        while src is not None:
            node = self.g.nodes[src]
            ins = self.preds.get(src, [])
            if node.op_type not in _TRIVIAL.values() or node.flops or len(ins) != 1:
                break
            src = ins[0]
        return src


def trace_training_graph(loss_fn, params, batch, name: str = "") -> CompGraph:
    """Trace ``value_and_grad(loss_fn)(params, batch)`` into a CompGraph
    with parameter sources, gradient producers, and ApplyGradient sinks.

    ``params`` and ``batch`` are nested dicts of tensors, real, fake or on
    the meta device; ``loss_fn(params, batch)`` returns the scalar loss. Node
    ``param_i`` is leaf ``i`` of ``params`` in ``jax.tree.flatten``'s
    order, as in ``jax_export``."""
    plist, blist = _flatten(params), _flatten(batch)
    n_params = len(plist)
    batch_size = int(blist[0].shape[0]) if blist and blist[0].dim() else 0

    def value_and_grad(*leaves):
        ps = list(leaves[:n_params])
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, ps), _unflatten(batch, leaves[n_params:]))
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        return (loss, *grads)

    args = [p.detach().requires_grad_(p.is_floating_point()) for p in plist] \
        + [b.detach() for b in blist]
    gm = make_fx(value_and_grad, tracing_mode="fake")(*args)

    ex = _Exporter(batch_size)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    param_nodes = []
    for i, (fx, arr) in enumerate(zip(placeholders, args)):
        is_param = i < n_params
        batched = not is_param and arr.dim() > 0 and arr.shape[0] == batch_size
        node = ex.new_node(
            name=f"param_{i}" if is_param else f"input_{i - n_params}",
            op_type="parameter",
            bytes_out=_nbytes(arr),
            param_bytes=_nbytes(arr) if is_param else 0.0,
            split=Split.OTHER if is_param else Split.CONCAT,
            is_param=is_param,
            batch_dim=batched,
        )
        if is_param:
            param_nodes.append(node)
        ex.src[fx] = node.op_id
        ex.bdim[fx] = 0 if batched else None

    ex.walk(gm)

    # outputs: (loss, *grads) in leaf order
    out = next(n for n in gm.graph.nodes if n.op == "output")
    grad_nodes = list(out.args[0])[1:1 + n_params]
    for i, gv in enumerate(grad_nodes):
        src = ex.producer(gv) if isinstance(gv, torch.fx.Node) else None
        if src is None:
            continue
        gnode = ex.g.nodes[src]
        gnode.is_grad_producer = True
        pb = _nbytes(plist[i])
        gnode.grad_bytes += pb
        apply_node = ex.new_node(
            name=f"apply_grad_{i}",
            op_type="apply_gradient",
            flops=3.0 * plist[i].numel(),   # adam-style update
            bytes_out=pb,
            split=Split.OTHER,
            is_apply_grad=True,
        )
        gnode.grad_of = apply_node.op_id
        ex.g.add_edge(src, apply_node.op_id, pb)
        ex.g.add_edge(param_nodes[i].op_id, apply_node.op_id, pb)

    ex.g.name = name
    ex.g.build_adj()
    return ex.g
