"""Per-device counts of one step, the port's counterpart of
``repro.core.hlo_analysis``: where ``repro`` parses the optimized HLO of a
compiled SPMD module, ``analyze_step`` runs the step once on ``meta``
tensors, under a dispatch mode that sees every aten op, and returns the
roofline inputs of one device in a ``StepStats`` with ``HloStats``' fields:

* ``flops``: matmul FLOPs (the ops of ``torch.utils.flop_counter``'s
  registry: mm, addmm, bmm, convolutions, attention), of position 0.
  ``parallel.tensor`` names the position whose compute runs (``at``); an op
  of the backward pass runs at the position of the forward call that made
  its autograd node, and an op outside any position (a row's CE, the
  gradient sums) counts for every position of its row, or of the mesh.
  ``per_position_flops`` holds every position's.
* ``bytes_accessed``: each aten op's operand and result bytes, views
  excepted, of position 0. Eager PyTorch fuses nothing, so this counts more
  than XLA's fused count, where a fusion's internal traffic stays on chip:
  read it as an upper bound.
* ``collective_bytes``, ``collective_counts`` and ``collective_wire_bytes``:
  position 0's collectives as ``parallel.tensor``'s helpers record them,
  with ``repro``'s ring factors (all-reduce 2x, the others 1x).
* ``while_trips``: empty, the port's steps have no while loops.
* ``temp_bytes``: the peak of position 0's live bytes over the step, of
  the storages the step itself allocates (the inputs excluded).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.parallel import tensor as tp_mod

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
_HOME = (0, 0)


@dataclass
class StepStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    while_trips: list = field(default_factory=list)
    # position 0's per-op attribution: aten op -> [bytes, flops, count]
    by_opcode: dict = field(default_factory=dict)
    per_position_flops: dict = field(default_factory=dict)   # (row, col) -> FLOPs
    temp_bytes: int = 0
    raw_flops: float = 0.0     # FlopCounterMode's total over every position
    raw_bytes: float = 0.0

    def summary(self, k: int = 15) -> str:
        lines = [f"flops={self.flops:.3e} bytes={self.bytes_accessed:.3e} "
                 f"coll={self.collective_wire_bytes:.3e}"]
        lines.append("-- by opcode (bytes desc) --")
        for oc, (b, f, c) in sorted(self.by_opcode.items(), key=lambda kv: -kv[1][0])[:k]:
            lines.append(f"  {oc:28s} bytes={b:.3e} flops={f:.3e} n={c:.0f}")
        lines.append("-- collectives --")
        for oc in sorted(self.collective_bytes):
            lines.append(f"  {oc:28s} bytes={self.collective_bytes[oc]:.3e} "
                         f"n={self.collective_counts[oc]:.0f}")
        return "\n".join(lines)


def _mine(key, pos=_HOME) -> bool:
    """Whether compute charged to ``key`` (``at``'s (row, col), col None for
    the whole row, None for the whole mesh) runs on position ``pos``."""
    return key is None or (key[0] == pos[0] and key[1] in (None, pos[1]))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _NodeTags(TorchFunctionMode):
    """Tags each autograd node that a torch call creates with the position
    the call ran for (``parallel.tensor.at``), and makes the node set that
    position when the backward pass runs it. Every call goes through the
    mode, so the nodes a call makes are the untagged ones its outputs reach
    (a composite op makes several)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        key = tp_mod.current_position()
        todo = [t.grad_fn for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or "tp_position" in node.metadata or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            node.metadata["tp_position"] = key
            node.register_prehook(self._enter(key))
            todo.extend(f for f, _ in node.next_functions)
        return out

    @staticmethod
    def _enter(key):
        def pre(grad_outputs):
            tp_mod.set_position(key)
        return pre


class _Counter(TorchDispatchMode):
    def __init__(self, preexisting: set):
        super().__init__()
        self.flops = defaultdict(float)          # key -> FLOPs
        self.bytes = defaultdict(float)
        self.by_op = defaultdict(lambda: [0.0, 0.0, 0])   # position 0's
        self.total_bytes = 0.0
        self.known = set(preexisting)            # storages not to count
        self.live = 0
        self.peak = 0
        self._refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        key = tp_mod.current_position()
        home = _mine(key)
        fl = 0.0
        packet = func._overloadpacket
        if packet in flop_registry:
            fl = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops[key] += fl
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view:
            nb = sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0]) + sum(map(_nbytes, outs))
            self.bytes[key] += nb
            self.total_bytes += nb
            if home:
                e = self.by_op[str(packet).split(".")[-1]]
                e[0] += nb
                e[1] += fl
                e[2] += 1
            if home:
                for t in outs:
                    self._track(t)
        return out

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known:
            return
        self.known.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        self._refs[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key, n):
        self.live -= n
        self.known.discard(key)
        self._refs.pop(key, None)


def analyze_step(fn, *args, mesh) -> StepStats:
    """Run ``fn(*args)`` once (on ``meta`` tensors: nothing is allocated) and
    count position 0's FLOPs, bytes, collectives and peak live bytes on
    ``mesh``. Returns ``StepStats``; the step's outputs are dropped."""
    del mesh  # the positions come from parallel.tensor's contexts
    pre = {t.untyped_storage()._cdata for t in tree_flatten(args)[0]
           if isinstance(t, torch.Tensor)}
    counter = _Counter(pre)
    prev = tp_mod.current_position()
    try:
        with tp_mod.collectives() as coll, FlopCounterMode(display=False) as fcm, \
                _NodeTags(), counter:
            out = fn(*args)
            del out
    finally:
        tp_mod.set_position(prev)
    keys = {k for k in counter.flops if k is not None and k[1] is not None}
    positions = sorted(keys) or [_HOME]
    per = {p: sum(f for k, f in counter.flops.items() if _mine(k, p)) for p in positions}
    mine = coll.of(0)
    cbytes = {op: float(b) for op, (_, b) in mine.items()}
    return StepStats(
        flops=per.get(_HOME, 0.0),
        bytes_accessed=sum(b for k, b in counter.bytes.items() if _mine(k)),
        collective_wire_bytes=sum(_WIRE_FACTOR[op] * b for op, b in cbytes.items()),
        collective_bytes=cbytes,
        collective_counts={op: float(c) for op, (c, _) in mine.items()},
        while_trips=[],
        by_opcode={k: list(v) for k, v in counter.by_op.items()},
        per_position_flops=per,
        temp_bytes=counter.peak,
        raw_flops=float(fcm.get_total_flops()),
        raw_bytes=counter.total_bytes)
