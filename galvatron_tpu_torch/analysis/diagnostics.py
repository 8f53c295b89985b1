"""Structured diagnostics raised by the strategy code and the linters.

Port of ``galvatron_tpu/analysis/diagnostics.py`` for the GLS codes: the
strategy schema, the structural and pipeline-engine validators, the
strategy lint, the checkpoint layer, elastic resume and the checkpoint
auditor report through `Diagnostic`, `make`, `did_you_mean`,
`DiagnosticError` (still a ``ValueError``) and `DiagnosticReport` (with the
``cli lint`` contract: `exit_code`, `to_json`, `render`). Codes and
severities are the reference's, so a strategy refused by one package is
refused with the same code by the other. The GLC, GLT and WA codes analyse
JAX programs and sources and are not registered here. Stdlib only.
"""

from __future__ import annotations

import difflib
import json
from dataclasses import asdict, dataclass, field
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
    "GLS007": (ERROR, "attention heads not divisible by tensor-parallel degree"),
    "GLS008": (ERROR, "sequence length not divisible by its shard degree"),
    "GLS009": (ERROR, "vocab size not divisible by vocab-parallel degree"),
    "GLS010": (ERROR, "cross-layer mesh-axis inconsistency within a pipeline stage"),
    "GLS011": (ERROR, "illegal activation-checkpoint placement"),
    "GLS013": (ERROR, "unsupported comm-precision (quantized collectives) configuration"),
    "GLS014": (ERROR, "serve-infeasible configuration (latency bound, KV budget, or layout)"),
    "GLS015": (ERROR, "serve world infeasible after mesh degradation"),
    "GLS016": (ERROR, "state motion changed the layout-invariant integrity digest"),
    "GLS017": (ERROR, "online autotuner fighting a pinned strategy"),
    "GLS101": (WARNING, "estimated per-device memory exceeds the HBM budget"),
    "GLS102": (WARNING, "expensive cross-layer redistribution between adjacent layers"),
    "GLS103": (WARNING, "suspicious but runnable configuration"),
    # ---- checkpoint portability, integrity and the auditor ----
    "GLS201": (ERROR, "model-config digest mismatch between checkpoint and run"),
    "GLS202": (ERROR, "optimizer state incompatible with the checkpoint's"),
    "GLS203": (ERROR, "no feasible strategy for the surviving mesh under the memory budget"),
    "GLS204": (ERROR, "checkpoint lacks the provenance elastic resume requires"),
    "GLS205": (ERROR, "world size changed but no replacement strategy was resolved"),
    "GLS206": (ERROR, "cross-strategy relayout unsupported for this model family"),
    "GLS207": (ERROR, "live in-memory strategy migration infeasible for this run"),
    "GLS210": (ERROR, "checkpoint step without a committed integrity manifest (torn save)"),
    "GLS211": (WARNING, "stray or orphaned entry in the checkpoint directory"),
    "GLS212": (ERROR, "malformed checkpoint manifest or inconsistent provenance"),
    "GLS213": (WARNING, "checkpoint predates provenance (not elastically resumable)"),
    "GLS214": (ERROR, "checkpoint bytes no longer match the manifest's integrity digest"),
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

    def exit_code(self) -> int:
        """The CLI contract: 0 = clean (warnings allowed), 1 = errors."""
        return 0 if self.ok else 1

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "summary": {
                    "errors": len(self.errors),
                    "warnings": len(self.warnings),
                    "codes": self.codes(),
                },
                "diagnostics": [asdict(d) for d in self.diagnostics],
            },
            indent=2,
        )

    def render(self) -> str:
        lines = [d.format() for d in self.diagnostics]
        lines.append("%d error(s), %d warning(s)" % (len(self.errors), len(self.warnings)))
        return "\n".join(lines)


def registry_table() -> str:
    """Markdown table of every registered code (``cli lint --explain``)."""
    lines = ["| code | severity | meaning |", "|------|----------|---------|"]
    for code in sorted(CODES):
        sev, title = CODES[code]
        lines.append("| %s | %s | %s |" % (code, sev, title))
    return "\n".join(lines)
