"""Violation / report plumbing for the kernel contract analyzer.

A :class:`Violation` is one broken contract at one location; a
:class:`Report` is the outcome of a sweep (``repro_torch.analysis.sweep``):
every violation found, how many checks ran, and which combos were
covered. Reports render as a human table and serialize to a stable JSON
shape (snapshot-tested in ``tests/test_torch_analysis.py``, equal to
the reference package's).

Baselines: a committed allowlist file maps violation *fingerprints*
(``RULE|location``) to a reason. Fingerprints deliberately exclude the
message text so count/byte details can drift without churning the
baseline; a rule firing anywhere new is always a new violation.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Mapping, Tuple

__all__ = [
    "Violation",
    "Report",
    "load_baseline",
    "write_baseline",
]

REPORT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract at one location.

    ``rule`` is a stable ID from :data:`repro_torch.analysis.rules.RULES`
    (e.g. ``"FUSE001"``); ``location`` identifies the artifact — a sweep
    combo (``"sobel5/pallas-interpret/reflect/gray/nms"``), a spec
    (``"spec:sobel7"``), or a source line (``"src/repro/core/x.py:12"``).
    """

    rule: str
    location: str
    message: str
    detail: Tuple[Tuple[str, str], ...] = ()

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.location}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "location": self.location,
            "message": self.message,
            "detail": dict(self.detail),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "Violation":
        detail = d.get("detail") or {}
        return cls(
            rule=str(d["rule"]),
            location=str(d["location"]),
            message=str(d.get("message", "")),
            detail=tuple(sorted((str(k), str(v)) for k, v in dict(detail).items())),
        )


def _sort_key(v: Violation) -> Tuple[str, str]:
    return (v.rule, v.location)


@dataclasses.dataclass
class Report:
    """Outcome of one analyzer run."""

    violations: List[Violation] = dataclasses.field(default_factory=list)
    allowlisted: List[Violation] = dataclasses.field(default_factory=list)
    checks: int = 0
    combos: List[str] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def add(self, violations: Iterable[Violation]) -> None:
        self.violations.extend(violations)

    def extend(self, other: "Report") -> None:
        self.violations.extend(other.violations)
        self.allowlisted.extend(other.allowlisted)
        self.checks += other.checks
        self.combos.extend(other.combos)

    @property
    def ok(self) -> bool:
        return not self.violations

    def apply_baseline(self, fingerprints: Mapping[str, str]) -> None:
        """Move violations whose fingerprint is allowlisted into
        ``allowlisted``; what remains is *new* and should fail the run."""
        fresh: List[Violation] = []
        for v in self.violations:
            if v.fingerprint in fingerprints:
                self.allowlisted.append(v)
            else:
                fresh.append(v)
        self.violations = fresh

    def summary(self) -> Dict[str, int]:
        by_rule: Dict[str, int] = {}
        for v in self.violations:
            by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
        return by_rule

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "version": REPORT_VERSION,
            "ok": self.ok,
            "checks": self.checks,
            "combos": sorted(self.combos),
            "summary": dict(sorted(self.summary().items())),
            "violations": [v.to_dict() for v in sorted(self.violations, key=_sort_key)],
            "allowlisted": [v.to_dict() for v in sorted(self.allowlisted, key=_sort_key)],
            "meta": dict(sorted(self.meta.items())),
        }

    def render(self, *, verbose: bool = False) -> str:
        """Human-readable table of the run."""
        from repro_torch.analysis.rules import RULES

        lines: List[str] = []
        head = (
            f"repro.analysis: {self.checks} checks over "
            f"{len(self.combos)} artifacts"
        )
        lines.append(head)
        rows = [("RULE", "LOCATION", "MESSAGE")]
        for v in sorted(self.violations, key=_sort_key):
            rows.append((v.rule, v.location, v.message))
        if len(rows) > 1:
            w0 = max(len(r[0]) for r in rows)
            w1 = max(len(r[1]) for r in rows)
            for r0, r1, r2 in rows:
                lines.append(f"  {r0:<{w0}}  {r1:<{w1}}  {r2}")
            for rule, n in sorted(self.summary().items()):
                name = RULES[rule].name if rule in RULES else "?"
                lines.append(f"  {rule} ({name}): {n} violation(s)")
            lines.append(f"FAIL: {len(self.violations)} new violation(s)")
        else:
            lines.append("OK: no new violations")
        if self.allowlisted:
            lines.append(f"  ({len(self.allowlisted)} baselined violation(s) suppressed)")
        if verbose:
            for c in sorted(self.combos):
                lines.append(f"  checked {c}")
        return "\n".join(lines)


def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> reason map from a committed allowlist file."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for entry in data.get("allow", []):
        fp = f"{entry['rule']}|{entry['location']}"
        out[fp] = str(entry.get("reason", ""))
    return out


def write_baseline(path: str, report: Report) -> None:
    """Write the current run's violations as the new allowlist baseline."""
    allow = [
        {"rule": v.rule, "location": v.location, "reason": v.message}
        for v in sorted(report.violations + report.allowlisted, key=_sort_key)
    ]
    data = {
        "version": REPORT_VERSION,
        "allow": allow,
        "clean_run": {
            "checks": report.checks,
            "artifacts": len(report.combos),
            "new_violations": len(report.violations),
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def render_coverage(report: Report) -> str:
    """Per-rule coverage of a sweep: the checks each rule ran, and every
    rule, or half of one, that did not run and why (``meta["rule_checks"]``
    and ``meta["not_run"]``, filled by :func:`repro_torch.analysis.sweep.analyze`).
    A rule that did not run is never counted as passed."""
    from repro_torch.analysis.rules import RULES

    ran = dict(report.meta.get("rule_checks", {}))
    not_run = dict(report.meta.get("not_run", {}))
    lines = [f"backends: {', '.join(report.meta.get('backends', ())) or '-'}"]
    for rule_id, rule in RULES.items():
        n = ran.get(rule_id, 0)
        why = not_run.get(rule_id, "no applicable check in this sweep")
        state = f"{n} check(s)" + (f"; not run: {why}" if rule_id in not_run else "") \
            if n else f"not run: {why}"
        lines.append(f"  {rule_id} ({rule.name}): {state}")
    return "\n".join(lines)
