"""Diagnostic model for the static plan verifier.

Every finding the verifier emits is a ``Diagnostic``: a stable code
(``TAGxxx``), a severity, a human message, and a source location inside
the deployment (stage, microbatch, chunk, event index). Codes are
API — tests, CI gates and the mutation self-test match on them, so a
code never changes meaning once shipped. The full table lives in
``CODES`` (and is rendered into the README's diagnostic-code table).

Severity semantics:

  * ``error`` — the deployment is unsound: it deadlocks, races, OOMs or
    references devices/links that cannot serve it. ``PlannerService``
    refuses to cache such a plan; preflight refuses to run it.
  * ``warn``  — legal but suspicious (mixed sync votes, >90% memory
    pressure, sync participants drifting from the searched placement).
  * ``info``  — lint-grade observations (degenerate collectives,
    microbatch normalization applied before verification).
"""
from __future__ import annotations

from dataclasses import dataclass, field
import enum
from typing import Iterable, Iterator


class Severity(enum.Enum):
    """Diagnostic severity: ``error`` is unsound, the rest is lint."""

    ERROR = "error"
    WARN = "warn"
    INFO = "info"

    def __str__(self) -> str:
        return self.value


# code -> (severity, short title). The message on each Diagnostic adds
# the instance-specific detail (exact overshoot bytes, cycle, ...).
CODES: dict[str, tuple[Severity, str]] = {
    # --- plan / input structure -------------------------------------
    "TAG001": (Severity.ERROR, "malformed schedule or plan structure"),
    "TAG002": (Severity.INFO, "microbatch count normalized for "
                              "verification"),
    # --- happens-before analysis ------------------------------------
    "TAG101": (Severity.ERROR, "schedule deadlock: happens-before cycle"),
    "TAG102": (Severity.ERROR, "backward issued before its forward"),
    "TAG103": (Severity.ERROR, "weight-grad issued before its backward"),
    "TAG104": (Severity.ERROR, "event coverage hole (missing event)"),
    "TAG105": (Severity.ERROR, "duplicate schedule event"),
    "TAG106": (Severity.ERROR, "unmatched send/recv at stage boundary"),
    "TAG107": (Severity.ERROR, "cross-stage transfer ordering race"),
    # --- memory-budget prover ---------------------------------------
    "TAG201": (Severity.ERROR, "device memory budget exceeded (OOM)"),
    "TAG202": (Severity.WARN, "memory pressure above 90% of capacity"),
    # --- collective matching ----------------------------------------
    "TAG301": (Severity.ERROR, "unknown gradient-sync mode"),
    "TAG302": (Severity.ERROR, "SFB sync on a single-device group"),
    "TAG303": (Severity.WARN, "mixed sync votes within one stage"),
    "TAG304": (Severity.INFO, "degenerate collective (1 participant)"),
    "TAG305": (Severity.WARN, "sync participants drift from searched "
                              "placement"),
    "TAG306": (Severity.INFO, "degenerate split: tiny per-device shard"),
    # --- placement feasibility --------------------------------------
    "TAG401": (Severity.ERROR, "stage spans not contiguous in "
                               "topological order"),
    "TAG402": (Severity.ERROR, "invalid device-group reference"),
    "TAG403": (Severity.ERROR, "stage capacity mismatch vs topology"),
    "TAG404": (Severity.ERROR, "scheduled transfer over unreachable "
                               "link"),
    "TAG405": (Severity.ERROR, "empty stage span"),
    "TAG406": (Severity.ERROR, "op group assigned to multiple stages"),
}


@dataclass(frozen=True)
class Loc:
    """Source location of a diagnostic inside a deployment."""

    stage: int | None = None
    mb: int | None = None
    chunk: int | None = None
    event_index: int | None = None

    def __str__(self) -> str:
        parts: list[str] = []
        if self.stage is not None:
            parts.append(f"stage {self.stage}")
        if self.chunk is not None:
            parts.append(f"chunk {self.chunk}")
        if self.mb is not None:
            parts.append(f"mb {self.mb}")
        if self.event_index is not None:
            parts.append(f"event #{self.event_index}")
        return ", ".join(parts)

    def to_dict(self) -> dict[str, int]:
        """JSON-safe dict with only the populated location fields."""
        out: dict[str, int] = {}
        for k in ("stage", "mb", "chunk", "event_index"):
            v = getattr(self, k)
            if v is not None:
                out[k] = int(v)
        return out


@dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable ``TAGxxx`` code, severity, message, location."""

    code: str
    severity: Severity
    message: str
    loc: Loc = Loc()

    @property
    def title(self) -> str:
        """Short title the code table assigns to this code."""
        return CODES[self.code][1] if self.code in CODES else self.code

    def format(self) -> str:
        """One human-readable ``CODE severity: [loc] message`` line."""
        where = str(self.loc)
        at = f" [{where}]" if where else ""
        return f"{self.code} {self.severity}:{at} {self.message}"

    def to_dict(self) -> dict[str, object]:
        """JSON-safe dict form (code, severity, title, message, loc)."""
        return {"code": self.code, "severity": str(self.severity),
                "title": self.title, "message": self.message,
                "loc": self.loc.to_dict()}


def make(code: str, message: str, *, stage: int | None = None,
         mb: int | None = None, chunk: int | None = None,
         event_index: int | None = None) -> Diagnostic:
    """Build a diagnostic with the severity the code table mandates."""
    sev, _title = CODES[code]
    return Diagnostic(code=code, severity=sev, message=message,
                      loc=Loc(stage=stage, mb=mb, chunk=chunk,
                              event_index=event_index))


@dataclass
class Report:
    """An ordered collection of diagnostics plus convenience views."""

    diagnostics: list[Diagnostic] = field(default_factory=list)

    def add(self, code: str, message: str, *, stage: int | None = None,
            mb: int | None = None, chunk: int | None = None,
            event_index: int | None = None) -> Diagnostic:
        """Append (and return) a diagnostic built from the code table."""
        d = make(code, message, stage=stage, mb=mb, chunk=chunk,
                 event_index=event_index)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "Report") -> "Report":
        """Absorb another report's diagnostics; returns ``self``."""
        self.diagnostics.extend(other.diagnostics)
        return self

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def errors(self) -> list[Diagnostic]:
        """Error-severity diagnostics, in report order."""
        return [d for d in self.diagnostics
                if d.severity is Severity.ERROR]

    def warnings(self) -> list[Diagnostic]:
        """Warn-severity diagnostics, in report order."""
        return [d for d in self.diagnostics if d.severity is Severity.WARN]

    def infos(self) -> list[Diagnostic]:
        """Info-severity diagnostics, in report order."""
        return [d for d in self.diagnostics if d.severity is Severity.INFO]

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostic is present."""
        return not self.errors()

    @property
    def verdict(self) -> str:
        """Worst severity present: ``error`` | ``warn`` | ``clean``."""
        if self.errors():
            return "error"
        if self.warnings():
            return "warn"
        return "clean"

    def codes(self) -> set[str]:
        """The set of distinct codes present in the report."""
        return {d.code for d in self.diagnostics}

    def has(self, *codes: str) -> bool:
        """True when every given code appears in the report."""
        got = self.codes()
        return all(c in got for c in codes)

    def summary(self) -> dict[str, object]:
        """Compact verdict dict (persisted into ``PlanRecord.meta``)."""
        return {"verdict": self.verdict,
                "errors": len(self.errors()),
                "warnings": len(self.warnings()),
                "infos": len(self.infos()),
                "codes": sorted(self.codes())}

    def to_dict(self) -> dict[str, object]:
        """JSON-safe dict: the summary plus every diagnostic."""
        return {"summary": self.summary(),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}

    def format(self, *, max_lines: int = 0) -> str:
        """Multi-line human rendering; truncated past ``max_lines``."""
        lines = [d.format() for d in self.diagnostics]
        if max_lines and len(lines) > max_lines:
            lines = [*lines[:max_lines],
                     f"... {len(self.diagnostics) - max_lines} more"]
        s = self.summary()
        head = (f"verify: {s['verdict']} ({s['errors']} error(s), "
                f"{s['warnings']} warning(s), {s['infos']} info)")
        return "\n".join([head, *lines])


class PlanVerificationError(RuntimeError):
    """Raised when a caller demands a clean plan and got errors."""

    def __init__(self, report: Report, context: str = ""):
        self.report = report
        head = f"plan verification failed ({context})" if context \
            else "plan verification failed"
        super().__init__(head + "\n" + report.format(max_lines=20))


def merge(reports: Iterable[Report]) -> Report:
    """Concatenate reports into one, preserving order."""
    out = Report()
    for r in reports:
        out.extend(r)
    return out
