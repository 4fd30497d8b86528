"""Versioned plan store: in-memory LRU over a JSON-on-disk tier.

Records are keyed by (graph_fp, topo_fp). The memory tier is a bounded
LRU; the disk tier (optional ``path=``) holds one JSON file per record
and survives process restarts — a warm planner re-serves yesterday's
strategies without a single MCTS playout.

The disk tier is bounded too: age/size budgets and per-topology quotas
(constructor arguments, enforced on every put, or on demand via
``evict_expired`` / the CLI's ``evict --max-age/--max-bytes``), and all
disk mutations take an ``fcntl`` lock on ``.lock`` in the cache
directory so multiple launcher processes can share one cache.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
import json
import os
import tempfile
import time

from repro_torch.core.sfb import GroupSFB
from repro_torch.core.strategy import Strategy

try:
    import fcntl
except ImportError:                        # non-posix: locking degrades
    fcntl = None

SCHEMA_VERSION = 1
LOCK_FILE = ".lock"


@contextmanager
def flock_dir(path: str | None, *, shared: bool = False,
              require_dir: bool = False):
    """fcntl file lock over a cache directory (shared with the policy
    registry); no-op when there is no directory to lock or fcntl is
    unavailable. ``require_dir`` skips locking until the directory exists
    (registries are created lazily on first save)."""
    if not path or fcntl is None or (require_dir and not os.path.isdir(path)):
        yield
        return
    with open(os.path.join(path, LOCK_FILE), "a+") as lf:
        fcntl.flock(lf, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


@dataclass
class PlanRecord:
    graph_fp: str
    topo_fp: str
    topo_struct_fp: str
    n_groups: int
    topo_m: int
    strategy: dict                     # Strategy.to_dict()
    sfb_plans: dict                    # {str(gid): GroupSFB.to_dict()}
    time: float                        # simulated per-iteration seconds
    baseline_time: float
    # structural feature vector of the planned graph
    # (service.fingerprint.structural_features) — the cross-model
    # warm-start tier ranks donor records by distance to it. Optional:
    # records written before the field existed load as [] and are simply
    # never structural donors.
    graph_features: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)   # iterations, seed, source...
    version: int = SCHEMA_VERSION

    @property
    def key(self):
        return (self.graph_fp, self.topo_fp)

    @property
    def speedup(self):
        return self.baseline_time / self.time if self.time > 0 else 0.0

    def strategy_obj(self) -> Strategy:
        return Strategy.from_dict(self.strategy)

    def sfb_objs(self) -> dict:
        return {int(gid): GroupSFB.from_dict(d)
                for gid, d in self.sfb_plans.items()}

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "graph_fp": self.graph_fp, "topo_fp": self.topo_fp,
            "topo_struct_fp": self.topo_struct_fp,
            "n_groups": self.n_groups, "topo_m": self.topo_m,
            "strategy": self.strategy, "sfb_plans": self.sfb_plans,
            "time": self.time, "baseline_time": self.baseline_time,
            "graph_features": [float(v) for v in self.graph_features],
            "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlanRecord":
        if d.get("version") != SCHEMA_VERSION:
            raise ValueError(f"plan record schema {d.get('version')} != "
                             f"{SCHEMA_VERSION}")
        return cls(
            graph_fp=d["graph_fp"], topo_fp=d["topo_fp"],
            topo_struct_fp=d["topo_struct_fp"],
            n_groups=int(d["n_groups"]), topo_m=int(d["topo_m"]),
            strategy=d["strategy"], sfb_plans=d["sfb_plans"],
            time=float(d["time"]), baseline_time=float(d["baseline_time"]),
            graph_features=list(d.get("graph_features", [])),
            meta=d.get("meta", {}), version=d["version"])


def _fname(graph_fp: str, topo_fp: str) -> str:
    return f"{graph_fp[:24]}-{topo_fp[:24]}.json"


class PlanStore:
    def __init__(self, capacity: int = 256, path: str | None = None,
                 max_age_s: float | None = None,
                 max_bytes: int | None = None,
                 per_topo_quota: int | None = None):
        self.capacity = capacity
        self.path = path
        self.max_age_s = max_age_s
        self.max_bytes = max_bytes
        self.per_topo_quota = per_topo_quota
        self._mem: OrderedDict = OrderedDict()   # key -> PlanRecord
        self._disk: dict = {}                    # key -> filename
        self._feat_cache: dict = {}              # key -> (mtime, feats, sp)
        if path:
            os.makedirs(path, exist_ok=True)
            with self._lock():
                self._scan_disk()

    # ------------------------------------------------------------- locking
    def _lock(self, shared: bool = False):
        """fcntl file lock over the cache directory; no-op for the pure
        memory tier or where fcntl is unavailable."""
        return flock_dir(self.path, shared=shared)

    # ---------------------------------------------------------------- disk
    def _scan_disk(self):
        for fn in os.listdir(self.path):
            if not fn.endswith(".json"):
                continue
            try:
                rec = self._load_file(fn)
            except (ValueError, KeyError, json.JSONDecodeError, OSError):
                continue                         # unreadable/stale schema
            self._disk[rec.key] = fn

    def _load_file(self, fn: str) -> PlanRecord:
        with open(os.path.join(self.path, fn)) as f:
            return PlanRecord.from_dict(json.load(f))

    def _write_file(self, rec: PlanRecord):
        fn = _fname(*rec.key)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(rec.to_dict(), f, sort_keys=True)
        os.replace(tmp, os.path.join(self.path, fn))
        self._disk[rec.key] = fn

    # ------------------------------------------------------------- get/put
    def _insert_mem(self, rec: PlanRecord):
        self._mem[rec.key] = rec
        self._mem.move_to_end(rec.key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)        # LRU; disk tier keeps it

    def put(self, rec: PlanRecord):
        self._insert_mem(rec)
        if self.path:
            with self._lock():
                self._write_file(rec)
                self._enforce_budgets()

    def get(self, graph_fp: str, topo_fp: str) -> PlanRecord | None:
        key = (graph_fp, topo_fp)
        rec = self._mem.get(key)
        if rec is not None:
            self._mem.move_to_end(key)
            return rec
        fn = self._disk.get(key)
        if fn is None and self.path:
            # another process may have written it since our last scan
            cand = _fname(*key)
            if os.path.exists(os.path.join(self.path, cand)):
                fn = cand
        if fn is not None:
            try:
                with self._lock(shared=True):
                    rec = self._load_file(fn)
            except (ValueError, KeyError, json.JSONDecodeError, OSError):
                self._disk.pop(key, None)
                return None
            if rec.key != key:                   # filename prefix collision
                return None
            self._disk[key] = fn
            self._insert_mem(rec)                # promote; no disk rewrite
            return rec
        return None

    def find(self, *, graph_fp: str | None = None,
             topo_fp: str | None = None) -> list:
        """Records matching one side of the key (warm-start donors)."""
        out, seen = [], set()
        for key in list(self._mem) + list(self._disk):
            if key in seen:
                continue
            seen.add(key)
            if graph_fp is not None and key[0] != graph_fp:
                continue
            if topo_fp is not None and key[1] != topo_fp:
                continue
            rec = self.get(*key)
            if rec is not None:
                out.append(rec)
        return out

    def records(self) -> list:
        return self.find()

    def feature_entries(self) -> list:
        """[(key, graph_features, speedup)] across both tiers WITHOUT
        promoting disk records into the memory LRU. The structural
        warm-start tier scans every stored plan on a cache miss; routing
        that scan through ``get()`` would evict hot memory-tier entries
        in favor of arbitrary donors and rewrite LRU order on every novel
        request. Disk-tier reads are memoized per (file, mtime), so
        repeated misses cost one stat per record instead of a full JSON
        parse — while still observing records other processes rewrite."""
        out = []
        for key, rec in self._mem.items():
            out.append((key, rec.graph_features, rec.speedup))
        seen = set(self._mem)
        for key, fn in list(self._disk.items()):
            if key in seen:
                continue
            path = os.path.join(self.path, fn)
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            cached = self._feat_cache.get(key)
            if cached is not None and cached[0] == mtime:
                out.append((key, cached[1], cached[2]))
                continue
            try:
                with self._lock(shared=True):
                    rec = self._load_file(fn)
            except (ValueError, KeyError, json.JSONDecodeError, OSError):
                continue
            self._feat_cache[key] = (mtime, rec.graph_features, rec.speedup)
            out.append((key, rec.graph_features, rec.speedup))
        return out

    # -------------------------------------------------------------- evict
    def _remove_key(self, key) -> bool:
        """Drop one key from both tiers (caller holds the lock)."""
        hit = False
        if key in self._mem:
            del self._mem[key]
            hit = True
        fn = self._disk.pop(key, None)
        if fn is not None:
            try:
                os.remove(os.path.join(self.path, fn))
            except OSError:
                pass
            hit = True
        return hit

    def evict(self, *, graph_fp: str | None = None,
              topo_fp: str | None = None, all: bool = False) -> int:
        """Remove matching records from both tiers. Fingerprints may be
        prefixes (the CLI prints truncated fps)."""
        n = 0
        with self._lock():
            self._scan_disk()      # see records other processes wrote
            for key in list(self._mem) + list(self._disk):
                if not all:
                    if graph_fp is not None \
                            and not key[0].startswith(graph_fp):
                        continue
                    if topo_fp is not None \
                            and not key[1].startswith(topo_fp):
                        continue
                    if graph_fp is None and topo_fp is None:
                        continue
                n += self._remove_key(key)
        return n

    # ------------------------------------------------- disk-tier budgets
    def _disk_entries(self):
        """[(key, fn, mtime, size)] for the disk tier, newest first."""
        out = []
        for key, fn in list(self._disk.items()):
            p = os.path.join(self.path, fn)
            try:
                st = os.stat(p)
            except OSError:
                self._disk.pop(key, None)
                continue
            out.append((key, fn, st.st_mtime, st.st_size))
        out.sort(key=lambda e: -e[2])
        return out

    def _enforce_budgets(self, now: float | None = None) -> int:
        """Apply age/size/per-topology budgets to the disk tier (caller
        holds the lock). Victims leave both tiers; newest records win.
        The directory is rescanned first so budgets cover records other
        processes sharing the cache wrote since our last scan."""
        if not self.path:
            return 0
        if self.max_age_s is None and self.max_bytes is None \
                and self.per_topo_quota is None:
            return 0
        self._scan_disk()
        now = time.time() if now is None else now
        entries = self._disk_entries()
        victims = set()
        if self.max_age_s is not None:
            victims |= {key for key, _, mtime, _ in entries
                        if now - mtime > self.max_age_s}
        if self.per_topo_quota is not None:
            seen: dict = {}
            for key, _, _, _ in entries:        # newest first
                if key in victims:
                    continue
                seen[key[1]] = seen.get(key[1], 0) + 1
                if seen[key[1]] > self.per_topo_quota:
                    victims.add(key)
        if self.max_bytes is not None:
            total = sum(size for key, _, _, size in entries
                        if key not in victims)
            for key, _, _, size in reversed(entries):   # oldest first
                if total <= self.max_bytes:
                    break
                if key in victims:
                    continue
                victims.add(key)
                total -= size
        n = 0
        for key in victims:
            n += self._remove_key(key)
        return n

    def evict_expired(self, *, max_age_s: float | None = None,
                      max_bytes: int | None = None,
                      per_topo_quota: int | None = None,
                      now: float | None = None) -> int:
        """One-shot disk-tier cleanup under explicit budgets (the CLI's
        ``evict --max-age/--max-bytes/--per-topo-quota``). Arguments
        default to the store's standing budgets."""
        saved = (self.max_age_s, self.max_bytes, self.per_topo_quota)
        if max_age_s is not None:
            self.max_age_s = max_age_s
        if max_bytes is not None:
            self.max_bytes = max_bytes
        if per_topo_quota is not None:
            self.per_topo_quota = per_topo_quota
        try:
            with self._lock():
                return self._enforce_budgets(now=now)
        finally:
            (self.max_age_s, self.max_bytes,
             self.per_topo_quota) = saved

    def __len__(self):
        return len(set(self._mem) | set(self._disk))

    def keys(self):
        return sorted(set(self._mem) | set(self._disk))
