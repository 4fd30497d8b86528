"""Planner-service CLI of the port, the commands of ``repro.service.cli``
whose modules the port has.

    python -m repro_torch.service.cli inspect --cache-dir .plans
    python -m repro_torch.service.cli evict --cache-dir .plans --max-age 86400
    python -m repro_torch.service.cli calibrate --topo h100 \
        --telemetry-dir .telemetry --save profile.json
    python -m repro_torch.service.cli policy list --cache-dir .plans
    python -m repro_torch.service.cli policy use --name corpus-a --cache-dir .plans
    python -m repro_torch.service.cli policy evict --max-count 4 --cache-dir .plans

``plan``, ``observe``, ``drift``, ``policy train``, ``trace`` and ``verify``
build a paper-zoo graph, and ``metrics``, ``serve-metrics`` and ``health``
serve the observability plane: neither is in the port yet (ROADMAP queue 1,
items 9 and 6). ``launch.serve --plan-topo`` plans and observes through
the same ``PlannerService``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import device as device_mod
from repro_torch.service.planner import POLICY_SUBDIR
from repro_torch.service.registry import PolicyRegistry
from repro_torch.service.store import PlanStore

TOPOLOGIES = {
    "testbed": device_mod.testbed,
    "cloud": device_mod.cloud,
    "2x1080ti": device_mod.two_1080ti,
    "2xv100": device_mod.homogeneous_2v100,
    "tpu": device_mod.tpu_pods,
    "h100": device_mod.h100_nodes,
}


def _build_topology(name: str):
    return TOPOLOGIES[name]()


def _registry(args) -> PolicyRegistry:
    return PolicyRegistry(os.path.join(args.cache_dir, POLICY_SUBDIR))


def cmd_policy_list(args) -> int:
    reg = _registry(args)
    default = reg.default_name()
    rows = [{
        "name": r.name, "default": r.name == default,
        "corpus": [fp[:16] for fp in r.corpus],
        "models": r.meta.get("models"), "steps": r.meta.get("steps"),
        "final_loss": r.meta.get("final_loss"), "created": r.created,
    } for r in reg.records()]
    print(json.dumps({"policies": rows, "count": len(rows),
                      "default": default}, indent=2))
    return 0


def cmd_policy_use(args) -> int:
    """Pin a registered policy: the planner serves every request with it
    (overrides corpus / structural matching) until re-pinned."""
    reg = _registry(args)
    try:
        reg.set_default(args.name)
    except (OSError, ValueError, KeyError) as e:
        print(json.dumps({"error": f"cannot pin {args.name!r}: {e}"}))
        return 1
    print(json.dumps({"default": args.name, "registry": reg.path}))
    return 0


def cmd_policy_evict(args) -> int:
    """Registry-level eviction: drop a named checkpoint and/or apply
    age / size / count budgets (pinned default is never evicted)."""
    reg = _registry(args)
    n = 0
    if args.name:
        n += int(reg.remove(args.name))
    if args.max_age is not None or args.max_bytes is not None \
            or args.max_count is not None:
        n += reg.evict_expired(max_age_s=args.max_age,
                               max_bytes=args.max_bytes,
                               max_count=args.max_count)
    print(json.dumps({"evicted": n, "remaining": len(reg),
                      "default": reg.default_name()}))
    return 0


def cmd_inspect(args) -> int:
    store = PlanStore(path=args.cache_dir)
    rows = [{
        "graph_fp": r.graph_fp[:16], "topo_fp": r.topo_fp[:16],
        "n_groups": r.n_groups, "topo_m": r.topo_m,
        "time_s": r.time, "speedup": round(r.speedup, 4),
        "meta": r.meta,
    } for r in store.records()]
    print(json.dumps({"records": rows, "count": len(rows)}, indent=2))
    return 0


def cmd_evict(args) -> int:
    store = PlanStore(path=args.cache_dir)
    n = 0
    if args.graph_fp or args.topo_fp or args.all:
        n += store.evict(graph_fp=args.graph_fp, topo_fp=args.topo_fp,
                         all=args.all)
    if args.max_age is not None or args.max_bytes is not None \
            or args.per_topo_quota is not None:
        n += store.evict_expired(max_age_s=args.max_age,
                                 max_bytes=args.max_bytes,
                                 per_topo_quota=args.per_topo_quota)
    print(json.dumps({"evicted": n, "remaining": len(store)}))
    return 0


def cmd_calibrate(args) -> int:
    """Fit a CalibrationProfile from accumulated step telemetry."""
    from repro_torch.runtime.calibration import fit_profile
    from repro_torch.runtime.telemetry import MeasurementStore
    from repro_torch.service.fingerprint import fingerprint_topology
    topo = _build_topology(args.topo)
    store = MeasurementStore(args.telemetry_dir)
    recs = store.records(
        topo_fp=fingerprint_topology(topo) if args.match_topo else None)
    if not recs:
        print(json.dumps({"error": "no matching measurements",
                          "telemetry_dir": args.telemetry_dir}))
        return 1
    profile = fit_profile(recs, topo)
    if args.save:
        profile.save(args.save)
    print(json.dumps({"topo": args.topo, "records": len(recs),
                      "profile": profile.to_dict(),
                      "saved": args.save or None}, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.service.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="list cached plan records")
    p.add_argument("--cache-dir", default=".plans")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("evict", help="remove cached plan records")
    p.add_argument("--cache-dir", default=".plans")
    p.add_argument("--graph-fp", default=None,
                   help="graph fingerprint (prefix) to evict")
    p.add_argument("--topo-fp", default=None,
                   help="topology fingerprint (prefix) to evict")
    p.add_argument("--all", action="store_true")
    p.add_argument("--max-age", type=float, default=None,
                   help="evict disk records older than SECONDS")
    p.add_argument("--max-bytes", type=int, default=None,
                   help="shrink the disk tier to this many bytes")
    p.add_argument("--per-topo-quota", type=int, default=None,
                   help="keep at most N records per topology")
    p.set_defaults(fn=cmd_evict)

    p = sub.add_parser("calibrate",
                       help="fit a calibration profile from telemetry")
    p.add_argument("--topo", choices=sorted(TOPOLOGIES), default="testbed")
    p.add_argument("--telemetry-dir", default=".telemetry")
    p.add_argument("--match-topo", action="store_true",
                   help="only use records whose topo fingerprint matches")
    p.add_argument("--save", default=None,
                   help="write the fitted profile JSON here")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("policy",
                       help="list / pin / evict registered GNN policies")
    psub = p.add_subparsers(dest="policy_cmd", required=True)

    pp = psub.add_parser("list", help="list registered policies")
    pp.add_argument("--cache-dir", default=".plans")
    pp.set_defaults(fn=cmd_policy_list)

    pp = psub.add_parser("use", help="pin the policy served by default")
    pp.add_argument("--name", required=True)
    pp.add_argument("--cache-dir", default=".plans")
    pp.set_defaults(fn=cmd_policy_use)

    pp = psub.add_parser("evict",
                         help="drop checkpoints by name or budget "
                              "(age/bytes/count; pinned default kept)")
    pp.add_argument("--name", default=None,
                    help="remove this checkpoint")
    pp.add_argument("--max-age", type=float, default=None,
                    help="evict checkpoints older than SECONDS")
    pp.add_argument("--max-bytes", type=int, default=None,
                    help="shrink the registry to this many bytes")
    pp.add_argument("--max-count", type=int, default=None,
                    help="keep at most N checkpoints (newest win)")
    pp.add_argument("--cache-dir", default=".plans")
    pp.set_defaults(fn=cmd_policy_evict)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
