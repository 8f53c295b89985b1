"""Structured diagnostics raised by the strategy code and the serve lint.

Port of the subset of ``galvatron_tpu/analysis/diagnostics.py`` that the
strategy schema, the structural validator and the serve-mode lint report
through: `Diagnostic`, `make`, `did_you_mean`, `DiagnosticError` (still a
``ValueError``) and `DiagnosticReport`. Codes and severities are the
reference's, so a strategy refused by one package is refused with the same
code by the other. Stdlib only.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"

# code -> (default severity, short title): the GLS codes this package emits.
CODES: Dict[str, Tuple[str, str]] = {
    "GLS001": (ERROR, "unknown or misspelled strategy-JSON key"),
    "GLS002": (ERROR, "device-grid divisibility violation (world/pp/tp/cp/vocab)"),
    "GLS003": (ERROR, "pipeline division inconsistent with pp/layer count"),
    "GLS004": (ERROR, "batch divisibility violation (global_bsz/chunks/dp)"),
    "GLS005": (ERROR, "invalid field value or flag"),
    "GLS006": (ERROR, "per-layer arrays disagree in length"),
    "GLS013": (ERROR, "unsupported comm-precision (quantized collectives) configuration"),
    "GLS014": (ERROR, "serve-infeasible configuration (latency bound, KV budget, or layout)"),
    "GLS103": (WARNING, "suspicious but runnable configuration"),
}


@dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str
    message: str
    file: Optional[str] = None
    line: Optional[int] = None
    layer: Optional[int] = None
    key: Optional[str] = None
    hint: Optional[str] = None

    def format(self) -> str:
        loc = self.file or "<strategy>"
        if self.line is not None:
            loc += ":%d" % self.line
        if self.layer is not None:
            loc += " [layer %d]" % self.layer
        msg = "%s: %s %s: %s" % (loc, self.severity, self.code, self.message)
        if self.hint:
            msg += " (%s)" % self.hint
        return msg


def make(code: str, message: str, **loc) -> Diagnostic:
    """Build a Diagnostic for a registered code (severity from the registry;
    pass ``severity=`` to override)."""
    if code not in CODES:
        raise KeyError("unregistered diagnostic code %r" % code)
    severity = loc.pop("severity", CODES[code][0])
    return Diagnostic(code=code, severity=severity, message=message, **loc)


def did_you_mean(name: str, candidates: Iterable[str]) -> Optional[str]:
    """Closest-match hint for typo'd keys, or None when nothing is close."""
    matches = difflib.get_close_matches(name, list(candidates), n=1, cutoff=0.6)
    return "did you mean %r?" % matches[0] if matches else None


class DiagnosticError(ValueError):
    """Structured validation failure carrying the diagnostics that caused it
    (all errors); renders like a plain ValueError."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__("; ".join("[%s] %s" % (d.code, d.message) for d in self.diagnostics))


@dataclass
class DiagnosticReport:
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})
