"""Policy registry: persistent trained-GNN checkpoints for the planner.

The paper's generalization claim (§5.2, Table 8) is that one trained
policy transfers to unseen models and topologies without fine-tuning.
This module makes that a *service* property: checkpoints trained via
``core.trainer.train_policy`` are persisted on disk next to the plan
store (JSON metadata + npz params, fcntl-locked like ``service.store``),
and ``PlannerService`` loads the best-matching checkpoint so cold and
warm searches run with trained priors by default.

Checkpoint selection, most- to least-specific:

  1. the pinned default (``python -m repro_torch.service.cli policy use NAME``) — absolute;
  2. a checkpoint whose training corpus contains the request's graph
     fingerprint (the model was trained on);
  3. the checkpoint whose corpus is structurally nearest the request
     (``fingerprint.structural_features`` cosine distance — the Table 8
     unseen-model transfer tier);
  4. the newest checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.hetgnn import GNNConfig
from repro_torch.service.fingerprint import structural_distance
from repro_torch.service.store import flock_dir

POLICY_SCHEMA_VERSION = 1
DEFAULT_FILE = "default.json"
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"bad policy name {name!r} (use letters, digits, "
                         f". _ -; max 64 chars)")
    if f"{name}.json" == DEFAULT_FILE:
        # would overwrite the pin file: the checkpoint's metadata becomes
        # invisible to records() and reads back as a phantom pin
        raise ValueError(f"policy name {name!r} is reserved")
    return name


@dataclass
class PolicyRecord:
    """One registered checkpoint's metadata (params live in ``<name>.npz``
    beside the ``<name>.json`` this serializes to)."""
    name: str
    cfg: dict                      # GNNConfig fields
    corpus: list                   # graph fingerprints trained on
    corpus_features: list          # structural feature vectors, ∥ corpus
    meta: dict = field(default_factory=dict)   # steps, mcts_iters, seed...
    created: float = 0.0
    version: int = POLICY_SCHEMA_VERSION

    def gnn_config(self) -> GNNConfig:
        return GNNConfig(**self.cfg)

    def distance_to(self, graph_features) -> float:
        """Distance from a request's structural features to the nearest
        graph in this checkpoint's training corpus."""
        ds = [structural_distance(graph_features, f)
              for f in self.corpus_features]
        return min(ds) if ds else float("inf")

    def to_dict(self) -> dict:
        return {"version": self.version, "name": self.name,
                "cfg": self.cfg, "corpus": list(self.corpus),
                "corpus_features": [list(map(float, f))
                                    for f in self.corpus_features],
                "meta": self.meta, "created": self.created}

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyRecord":
        if d.get("version") != POLICY_SCHEMA_VERSION:
            raise ValueError(f"policy record schema {d.get('version')} != "
                             f"{POLICY_SCHEMA_VERSION}")
        return cls(name=d["name"], cfg=d["cfg"],
                   corpus=list(d.get("corpus", [])),
                   corpus_features=list(d.get("corpus_features", [])),
                   meta=d.get("meta", {}),
                   created=float(d.get("created", 0.0)),
                   version=d["version"])


class PolicyRegistry:
    """Disk-backed registry of trained GNN policies.

    All disk mutations take an fcntl lock on ``.lock`` in the registry
    directory (shared for reads), mirroring ``PlanStore`` — many launcher
    processes can train into / serve from one registry.

    Eviction budgets (mirroring the plan store's disk-tier budgets):
    ``max_age_s`` drops checkpoints older than this, ``max_bytes`` caps
    the registry's on-disk size (json + npz, oldest evicted first),
    ``max_count`` caps the checkpoint count (newest win). Budgets are
    enforced on every ``save`` and on demand via ``evict_expired`` /
    the ``python -m repro_torch.service.cli policy evict`` CLI. The pinned default is never a
    victim — an operator's explicit pin outranks any budget.

    Checkpoints are numpy npz files, the layout ``repro``'s registry writes
    and reads; ``resolve`` builds the policy on ``device`` (cuda unless
    asked otherwise: without a card that raises).
    """

    def __init__(self, path: str, *, max_age_s: float | None = None,
                 max_bytes: int | None = None,
                 max_count: int | None = None, device=None):
        self.path = path
        self.device = device
        self.max_age_s = max_age_s
        self.max_bytes = max_bytes
        self.max_count = max_count
        self._policies: dict = {}      # name -> (PolicyRecord, policy)

    # ------------------------------------------------------------- locking
    def _lock(self, shared: bool = False):
        return flock_dir(self.path, shared=shared, require_dir=True)

    # --------------------------------------------------------------- paths
    def _meta_path(self, name: str) -> str:
        return os.path.join(self.path, f"{_check_name(name)}.json")

    def _params_path(self, name: str) -> str:
        return os.path.join(self.path, f"{_check_name(name)}.npz")

    # ------------------------------------------------------------ save/load
    def save(self, name: str, cfg: GNNConfig, params: dict, *,
             corpus=(), corpus_features=(), meta: dict | None = None,
             created: float | None = None) -> PolicyRecord:
        """Register a trained checkpoint (atomic npz + JSON writes)."""
        _check_name(name)
        os.makedirs(self.path, exist_ok=True)
        rec = PolicyRecord(
            name=name,
            cfg={"hidden": cfg.hidden, "heads": cfg.heads,
                 "layers": cfg.layers, "decoder_hidden": cfg.decoder_hidden},
            corpus=list(corpus),
            corpus_features=[list(map(float, f)) for f in corpus_features],
            meta=dict(meta or {}),
            created=time.time() if created is None else created)
        with self._lock():
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v) for k, v in params.items()})
            os.replace(tmp, self._params_path(name))
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".json.tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(rec.to_dict(), f, sort_keys=True)
            os.replace(tmp, self._meta_path(name))
            self._enforce_budgets()
        self._policies.pop(name, None)       # invalidate any cached build
        return rec

    def load(self, name: str):
        """-> (PolicyRecord, params dict of numpy arrays). Raises if
        absent/corrupt."""
        with self._lock(shared=True):
            with open(self._meta_path(name)) as f:
                rec = PolicyRecord.from_dict(json.load(f))
            with np.load(self._params_path(name)) as z:
                params = {k: z[k] for k in z.files}
        return rec, params

    def records(self) -> list:
        """All readable checkpoints, newest first."""
        if not os.path.isdir(self.path):
            return []
        out = []
        with self._lock(shared=True):
            for fn in sorted(os.listdir(self.path)):
                if not fn.endswith(".json") or fn == DEFAULT_FILE:
                    continue
                try:
                    with open(os.path.join(self.path, fn)) as f:
                        rec = PolicyRecord.from_dict(json.load(f))
                except (ValueError, KeyError, json.JSONDecodeError,
                        OSError):
                    continue
                if os.path.exists(self._params_path(rec.name)):
                    out.append(rec)
        out.sort(key=lambda r: -r.created)
        return out

    def remove(self, name: str) -> bool:
        hit = False
        with self._lock():
            for p in (self._meta_path(name), self._params_path(name)):
                try:
                    os.remove(p)
                    hit = True
                except OSError:
                    pass
            if self.default_name() == name:
                try:
                    os.remove(os.path.join(self.path, DEFAULT_FILE))
                except OSError:
                    pass
        self._policies.pop(name, None)
        return hit

    # -------------------------------------------------------------- default
    def set_default(self, name: str):
        """Pin a checkpoint (``python -m repro_torch.service.cli policy use``): selection returns
        it unconditionally until unpinned."""
        self.load(name)                      # validate it exists + loads
        os.makedirs(self.path, exist_ok=True)
        with self._lock():
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".json.tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"name": name}, f)
            os.replace(tmp, os.path.join(self.path, DEFAULT_FILE))

    def default_name(self) -> str | None:
        try:
            with open(os.path.join(self.path, DEFAULT_FILE)) as f:
                return json.load(f).get("name")
        except (OSError, json.JSONDecodeError):
            return None

    # ------------------------------------------------------------- budgets
    def _entries(self):
        """[(name, mtime, bytes)] per checkpoint, newest first (caller
        holds the lock)."""
        out = []
        for fn in os.listdir(self.path):
            if not fn.endswith(".json") or fn == DEFAULT_FILE:
                continue
            name = fn[:-len(".json")]
            try:
                st = os.stat(os.path.join(self.path, fn))
            except (OSError, ValueError):
                continue
            mtime, size = st.st_mtime, st.st_size
            try:
                size += os.stat(self._params_path(name)).st_size
            except (OSError, ValueError):
                pass       # orphaned meta (npz gone): still budget-
                #            visible so eviction can clean it up
            out.append((name, mtime, size))
        out.sort(key=lambda e: -e[1])
        return out

    def _remove_files(self, name: str) -> bool:
        hit = False
        for p in (self._meta_path(name), self._params_path(name)):
            try:
                os.remove(p)
                hit = True
            except OSError:
                pass
        self._policies.pop(name, None)
        return hit

    def _enforce_budgets(self, now: float | None = None) -> int:
        """Apply age/size/count budgets (caller holds the lock). Newest
        checkpoints win; the pinned default is never evicted."""
        if self.max_age_s is None and self.max_bytes is None \
                and self.max_count is None:
            return 0
        now = time.time() if now is None else now
        pinned = self.default_name()
        entries = [e for e in self._entries()]
        victims = set()
        if self.max_age_s is not None:
            victims |= {n for n, mtime, _ in entries
                        if now - mtime > self.max_age_s and n != pinned}
        if self.max_count is not None:
            # the pinned checkpoint always survives and fills a slot
            kept = sum(1 for n, _, _ in entries
                       if n == pinned and n not in victims)
            for n, _, _ in entries:             # newest first
                if n in victims or n == pinned:
                    continue
                kept += 1
                if kept > self.max_count:
                    victims.add(n)
        if self.max_bytes is not None:
            total = sum(s for n, _, s in entries if n not in victims)
            for n, _, s in reversed(entries):   # oldest first
                if total <= self.max_bytes:
                    break
                if n in victims or n == pinned:
                    continue
                victims.add(n)
                total -= s
        return sum(self._remove_files(n) for n in victims)

    def evict_expired(self, *, max_age_s: float | None = None,
                      max_bytes: int | None = None,
                      max_count: int | None = None,
                      now: float | None = None) -> int:
        """One-shot cleanup under explicit budgets (the CLI's ``policy
        evict``). Arguments default to the registry's standing budgets."""
        saved = (self.max_age_s, self.max_bytes, self.max_count)
        if max_age_s is not None:
            self.max_age_s = max_age_s
        if max_bytes is not None:
            self.max_bytes = max_bytes
        if max_count is not None:
            self.max_count = max_count
        try:
            if not os.path.isdir(self.path):
                return 0
            with self._lock():
                return self._enforce_budgets(now=now)
        finally:
            (self.max_age_s, self.max_bytes, self.max_count) = saved

    # ------------------------------------------------------------ selection
    def select(self, graph_fp: str | None = None,
               graph_features=None) -> PolicyRecord | None:
        """Best-matching checkpoint for a request (see module docstring
        for the tier order). Returns None when the registry is empty."""
        recs = self.records()
        if not recs:
            return None
        default = self.default_name()
        if default is not None:
            for r in recs:
                if r.name == default:
                    return r
        if graph_fp is not None:
            exact = [r for r in recs if graph_fp in r.corpus]
            if exact:
                return exact[0]              # newest among exact matches
        if graph_features:
            scored = [(r.distance_to(graph_features), r) for r in recs]
            scored = [(d, r) for d, r in scored if d != float("inf")]
            if scored:
                return min(scored, key=lambda x: x[0])[1]
        return recs[0]                       # newest overall

    def resolve(self, graph_fp: str | None = None, graph_features=None):
        """-> (name, policy callable) for the best-matching checkpoint, or
        (None, None). Built policies are cached per name, so the npz load
        and GNN setup happen once per registry instance."""
        rec = self.select(graph_fp=graph_fp, graph_features=graph_features)
        if rec is None:
            return None, None
        cached = self._policies.get(rec.name)
        if cached is not None and cached[0].created != rec.created:
            cached = None      # re-registered (possibly by another
            #                    process) since we built it: reload
        if cached is None:
            from repro_torch.core.trainer import make_policy
            try:
                rec, params = self.load(rec.name)
            except (OSError, ValueError, KeyError):
                return None, None
            cached = (rec, make_policy(rec.gnn_config(), params, device=self.device))
            self._policies[rec.name] = cached
        return cached[0].name, cached[1]

    def __len__(self):
        return len(self.records())
