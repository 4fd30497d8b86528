"""GNN policy training (paper §4.2.2), the counterpart of
``repro.core.trainer``.

Each step: sample a (DNN graph, device topology) pair, run MCTS with the
current policy, collect (state, visit-distribution) records at vertices
with enough visits, and minimize cross-entropy between the GNN prior
G_theta(s, a) and the MCTS selection probability pi(s, a) = N / sum N.

Gradients come from ``torch.autograd`` and the update is the port's AdamW.
The policy runs on the device its parameters are on: the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
import hashlib

import numpy as np
import torch

from repro_torch.core.device import Topology, random_topology
from repro_torch.core.features import HetGraph
from repro_torch.core.graph import GroupedGraph
from repro_torch.core.hetgnn import (
    GNNConfig, _het_arrays, action_slices, actions_to_arrays, embed_hetgraph, het_tensors,
    init_gnn, params_from_numpy, policy_probs, record_loss_core, score_embedded)
from repro_torch.core.mcts import MCTS
from repro_torch.launch.device import resolve_device
from repro_torch.optim.adam import AdamW


@dataclass
class TrainState:
    cfg: GNNConfig
    params: dict
    opt: AdamW
    opt_state: dict
    step: int = 0
    losses: list = field(default_factory=list)


class CachedPolicy:
    """GNN policy with per-(HetGraph, params) embedding memoization.

    ``gnn_forward`` (4 GAT layers over the full heterogeneous graph) is by
    far the dominant cost of a policy query, yet its inputs are fixed for
    every expansion that scores the same HetGraph — MCTS feeds the
    episode-static featurization (see ``MCTS._static_het``) precisely so
    this cache collapses the encoder to one run per search; only the thin
    ``score_actions`` decoder runs per op group. Keys are content hashes
    of the feature arrays (never ``id()`` — a GC'd graph's id can be
    reused), and the cache is LRU-bounded.

    The embeddings stay on the parameters' device, and so do the candidate
    slices of each action list (a search offers a handful of lists, each
    copied there once): an expansion copies only its probabilities back.
    """

    cache_embeddings = True     # advertised to MCTS (static featurization)

    def __init__(self, cfg: GNNConfig, params: dict, max_entries: int = 8):
        self.cfg = cfg
        self.params = params
        self.max_entries = max_entries
        self._cache: "OrderedDict" = OrderedDict()
        self._slices: dict = {}
        self.hits = 0
        self.misses = 0

    def _key(self, het: HetGraph):
        h = hashlib.sha1()
        for a in _het_arrays(het):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()

    @torch.no_grad()
    def embeddings(self, het: HetGraph):
        key = self._key(het)
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            self._cache.move_to_end(key)
            return hit
        self.misses += 1
        e = embed_hetgraph(self.cfg, self.params, het)
        self._cache[key] = e
        while len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)
        return e

    @torch.no_grad()
    def __call__(self, het: HetGraph, gid: int, actions):
        e_op, e_dev = self.embeddings(het)
        m = het.dev_x.shape[0]
        key = (tuple(actions), m)
        slices = self._slices.get(key)
        if slices is None:
            slices = self._slices[key] = action_slices(self.params, actions, m)
        logits = score_embedded(self.cfg, self.params, e_op, e_dev, gid, actions, m, slices)
        return torch.softmax(logits, dim=0).cpu().numpy()


def make_policy(cfg: GNNConfig, params: dict, *, cache_embeddings: bool = True,
                device=None):
    """Build an MCTS-facing policy callable from trained GNN params.

    ``params`` (tensors, or ``repro``'s numpy arrays) are put on ``device``,
    cuda unless asked otherwise; without a card that raises.

    With ``cache_embeddings`` (default) the returned policy memoizes the
    encoder per featurized graph and MCTS feeds it the episode-static
    featurization — one ``gnn_forward`` per search instead of one per
    expansion. Pass False for the exact per-vertex featurization
    (strategy-so-far context in the encoder input, pre-memoization
    behaviour).
    """
    params = params_from_numpy(params, device)
    if cache_embeddings:
        return CachedPolicy(cfg, params)

    @torch.no_grad()
    def policy(het: HetGraph, gid: int, actions):
        return policy_probs(cfg, params, het, gid, actions).cpu().numpy()
    return policy


def init_trainer(cfg: GNNConfig | None = None, seed: int = 0,
                 lr: float = 3e-4, device=None) -> TrainState:
    cfg = cfg or GNNConfig()
    dev = resolve_device(device)
    params = init_gnn(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt = AdamW(lr=lr, weight_decay=0.0, state_dtype="float32")
    return TrainState(cfg, params, opt, opt.init(params))


def train_step(state: TrainState, records, *, use_feedback: bool = True):
    """One gradient step over a list of MCTS visit records: each record's
    loss and gradient, accumulated in record order, then their mean through
    AdamW. The updated parameters are new tensors, so a policy built on the
    old ones keeps them, as ``repro``'s does."""
    if not records:
        return 0.0
    dev, dt = state.params["enc_op"].device, state.params["enc_op"].dtype
    names = list(state.params)
    losses, acc = [], None
    for (het, gid, actions, pi) in records:
        if not use_feedback:
            het = _strip_feedback(het)
        P, O, mask = actions_to_arrays(actions, het.dev_x.shape[0], bucket=1)
        pi_pad = np.zeros((P.shape[0],), np.float32)
        pi_pad[:len(pi)] = pi
        leaves = [state.params[k].detach().requires_grad_(True) for k in names]
        loss = record_loss_core(state.cfg, dict(zip(names, leaves, strict=True)),
                                _het_arrays(het_tensors(het, dev, dt)), gid, P, O, mask, pi_pad)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        acc = list(grads) if acc is None else [a + g for a, g in zip(acc, grads, strict=True)]
    grads = {k: g / len(records) for k, g in zip(names, acc, strict=True)}
    state.params = {k: v.clone() for k, v in state.params.items()}
    state.params, state.opt_state = state.opt.update(
        state.params, state.opt_state, grads, state.step)
    state.step += 1
    mean = sum(float(x) for x in torch.stack(losses).cpu()) / len(records)
    state.losses.append(mean)
    return mean


def _strip_feedback(het: HetGraph) -> HetGraph:
    """Ablation (paper §5.5): zero the runtime-feedback features."""
    op_x = het.op_x.copy()
    op_x[:, 7] = 0.0
    op_x[:, 8] = 0.0
    dev_x = het.dev_x.copy()
    dev_x[:, 4] = 0.0
    dev_x[:, 5] = 0.0
    dd_e = het.dd_e.copy()
    dd_e[:, :, 1] = 0.0
    return HetGraph(op_x, dev_x, het.oo_mask, het.oo_e, het.dd_mask,
                    dd_e, het.od_e)


def train_policy(state: TrainState, graphs: list, *, steps: int = 20,
                 mcts_iters: int = 24, seed: int = 0,
                 topologies: list | None = None,
                 use_feedback: bool = True, verbose: bool = False):
    """Paper's training loop: random (graph, topology) pairs per step."""
    rng = np.random.default_rng(seed)
    dev = state.params["enc_op"].device
    for step in range(steps):
        gg: GroupedGraph = graphs[int(rng.integers(len(graphs)))]
        topo: Topology = (topologies[int(rng.integers(len(topologies)))]
                          if topologies else random_topology(rng))
        policy = make_policy(state.cfg, state.params, device=dev)
        mcts = MCTS(gg, topo, policy=policy, seed=int(rng.integers(1 << 31)),
                    record_threshold=6)
        sr = mcts.search(mcts_iters)
        loss = train_step(state, sr.visit_records, use_feedback=use_feedback)
        if verbose:
            print(f"  gnn step {step}: loss={loss:.4f} "
                  f"records={len(sr.visit_records)} "
                  f"best_speedup={sr.best_reward:.2f}", flush=True)
    return state
