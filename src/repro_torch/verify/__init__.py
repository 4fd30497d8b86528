"""Static plan verifier: device-free analyses over searched deployments.

Happens-before deadlock/race detection, per-device memory-budget
proofs, collective-matching and placement-feasibility lint — all
emitted as stable ``TAGxxx`` diagnostics.

    from repro_torch.verify import verify_deployment
    report = verify_deployment(gg, strategy, topo)
    if not report.ok:
        raise PlanVerificationError(report)
"""
from repro_torch.verify.diagnostics import (
    CODES, Diagnostic, Loc, PlanVerificationError, Report, Severity)
from repro_torch.verify.verifier import (
    verify_deployment, verify_preflight, verify_schedule,
    verify_stage_plan)
from repro_torch.verify.mutate import MUTATIONS, make_context, run_selftest

__all__ = [
    "CODES", "Diagnostic", "Loc", "MUTATIONS", "PlanVerificationError",
    "Report", "Severity", "make_context", "run_selftest",
    "verify_deployment", "verify_preflight", "verify_schedule",
    "verify_stage_plan",
]
