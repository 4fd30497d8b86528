"""SLO tracking + multi-window burn-rate alerting for run health.

The step-time SLO is framed the SRE way: an *objective* fraction of
steps (default 99%) must finish under a *target* wall time. Each step is
a good/bad sample; the error budget is ``1 - objective``; the **burn
rate** over a window is ``bad_fraction(window) / (1 - objective)`` — a
burn rate of 1.0 spends the budget exactly at its sustainable pace,
14.4 spends a 30-day budget in ~2 days.

An ``AlertRule`` is the classic two-window form: it fires only when the
burn rate exceeds its threshold over BOTH the long window (persistence —
one bad step cannot page) and the short window (recency — an incident
that already ended stops paging as soon as the short window drains).
``default_rules()`` ships a page/warn pair over 1h/5m windows; callers
override via ``serve-metrics --alert-rules rules.json``.

Everything is timestamp-driven (no hidden ``time.time()`` in the math):
``SLOTracker.observe(ts, value)`` buffers samples, ``burn_rate(window,
now)`` evaluates at an explicit instant — deterministic under test and
under replayed telemetry.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
import json

SEVERITIES = ("page", "warn")

DEFAULT_OBJECTIVE = 0.99              # 99% of steps under the target


@dataclass(frozen=True)
class AlertRule:
    """One two-window burn-rate rule.

    Fires when the SLO burn rate is >= ``burn_rate`` over BOTH
    ``long_window_s`` and ``short_window_s``.
    """
    name: str
    severity: str                     # "page" | "warn"
    burn_rate: float                  # budget-consumption multiple
    long_window_s: float
    short_window_s: float

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} "
                             f"(use one of {SEVERITIES})")
        if self.burn_rate <= 0:
            raise ValueError("burn_rate must be > 0")
        if not (0 < self.short_window_s <= self.long_window_s):
            raise ValueError("need 0 < short_window_s <= long_window_s")

    def to_dict(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "burn_rate": self.burn_rate,
                "long_window_s": self.long_window_s,
                "short_window_s": self.short_window_s}

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        return cls(name=str(d["name"]), severity=str(d["severity"]),
                   burn_rate=float(d["burn_rate"]),
                   long_window_s=float(d["long_window_s"]),
                   short_window_s=float(d["short_window_s"]))


def default_rules(*, long_window_s: float = 3600.0,
                  short_window_s: float = 300.0) -> list:
    """The stock page/warn pair over 1h/5m windows.

    With the default 99% objective: the page rule trips at >= 14.4% bad
    steps sustained across both windows, the warn rule at >= 3%.
    """
    return [
        AlertRule(name="slo_fast_burn", severity="page", burn_rate=14.4,
                  long_window_s=long_window_s,
                  short_window_s=short_window_s),
        AlertRule(name="slo_slow_burn", severity="warn", burn_rate=3.0,
                  long_window_s=long_window_s,
                  short_window_s=short_window_s),
    ]


def parse_rules(text: str) -> list:
    """Parse a JSON list of AlertRule dicts (the ``--alert-rules`` file
    format); raises ``ValueError`` on schema violations."""
    try:
        raw = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"alert rules are not valid JSON: {e}") from None
    if not isinstance(raw, list) or not raw:
        raise ValueError("alert rules must be a non-empty JSON list")
    try:
        rules = [AlertRule.from_dict(d) for d in raw]
    except (KeyError, TypeError) as e:
        raise ValueError(f"alert rule missing field: {e}") from None
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate alert rule names in {names}")
    return rules


def load_rules(path: str) -> list:
    with open(path) as f:
        return parse_rules(f.read())


class SLOTracker:
    """Sliding-window good/bad step buffer + burn-rate queries.

    ``observe(ts, value_s)`` classifies one step against ``target_s``;
    ``burn_rate(window_s, now)`` is the bad fraction over ``(now -
    window_s, now]`` divided by the error budget. Samples older than
    ``horizon_s`` (set this to the longest rule window) are pruned on
    every observe, so memory is bounded by the window, not the run.
    """

    def __init__(self, target_s: float, *,
                 objective: float = DEFAULT_OBJECTIVE,
                 horizon_s: float = 3600.0, max_samples: int = 100_000):
        if target_s <= 0:
            raise ValueError("SLO target must be > 0 seconds")
        if not (0 < objective < 1):
            raise ValueError("objective must be in (0, 1)")
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.horizon_s = float(horizon_s)
        self._samples: deque = deque(maxlen=max_samples)  # (ts, bad)
        self.total = 0                     # lifetime counters
        self.bad = 0

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def observe(self, ts: float, value_s: float) -> bool:
        """Record one step; returns True when it violated the target."""
        bad = float(value_s) > self.target_s
        self._samples.append((float(ts), bad))
        self.total += 1
        self.bad += int(bad)
        cutoff = float(ts) - self.horizon_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()
        return bad

    def bad_fraction(self, window_s: float, now: float) -> float:
        """Bad fraction over ``(now - window_s, now]``; 0.0 when the
        window holds no samples (no data is not an incident)."""
        lo = now - window_s
        n = nbad = 0
        for ts, bad in reversed(self._samples):
            if ts <= lo or ts > now:
                if ts <= lo:
                    break                  # deque is time-ordered
                continue
            n += 1
            nbad += int(bad)
        return nbad / n if n else 0.0

    def burn_rate(self, window_s: float, now: float) -> float:
        return self.bad_fraction(window_s, now) / self.budget

    def to_dict(self, now: float | None = None, windows=()) -> dict:
        d = {"target_s": self.target_s, "objective": self.objective,
             "total": self.total, "bad": self.bad,
             "buffered": len(self._samples)}
        if now is not None:
            d["burn"] = {str(int(w)): self.burn_rate(w, now)
                         for w in windows}
        return d


@dataclass
class AlertState:
    """Live state of one rule: ok | firing, with transition bookkeeping."""
    rule: AlertRule
    state: str = "ok"
    since: float = 0.0                 # ts of the last transition
    burn_long: float = 0.0
    burn_short: float = 0.0
    transitions: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def firing(self) -> bool:
        return self.state == "firing"

    def to_dict(self) -> dict:
        return {"rule": self.rule.name, "severity": self.rule.severity,
                "state": self.state, "since": self.since,
                "burn_long": self.burn_long,
                "burn_short": self.burn_short,
                "threshold": self.rule.burn_rate,
                "long_window_s": self.rule.long_window_s,
                "short_window_s": self.rule.short_window_s,
                "transitions": self.transitions, **self.meta}


class AlertEvaluator:
    """Evaluates a rule set against one ``SLOTracker``.

    ok -> firing when both windows burn past the threshold; firing -> ok
    as soon as the SHORT window drops back under it (fast recovery: the
    long window remembers the incident, the short window proves it
    ended). Returns the states whose ``state`` changed this evaluation.
    """

    def __init__(self, rules=None):
        self.rules = list(rules if rules is not None else default_rules())
        self._states = {r.name: AlertState(rule=r) for r in self.rules}

    @property
    def horizon_s(self) -> float:
        return max((r.long_window_s for r in self.rules), default=3600.0)

    def evaluate(self, tracker: SLOTracker, now: float) -> list:
        changed = []
        for rule in self.rules:
            st = self._states[rule.name]
            st.burn_long = tracker.burn_rate(rule.long_window_s, now)
            st.burn_short = tracker.burn_rate(rule.short_window_s, now)
            should_fire = (st.burn_long >= rule.burn_rate
                           and st.burn_short >= rule.burn_rate)
            if should_fire and st.state == "ok":
                st.state, st.since = "firing", now
                st.transitions += 1
                changed.append(st)
            elif st.state == "firing" \
                    and st.burn_short < rule.burn_rate:
                st.state, st.since = "ok", now
                st.transitions += 1
                changed.append(st)
        return changed

    def states(self) -> list:
        return [self._states[r.name] for r in self.rules]

    def firing(self) -> list:
        return [st for st in self.states() if st.firing]
