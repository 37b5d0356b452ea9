"""Diagnostic objects shared by every verifier pass.

A ``Diagnostic`` is one statically-detected fact about a StreamPlan (or
the engine configuration around it).  Severities:

  * ``error``   — the plan is illegal: executing it would produce wrong
    results, alias a donated buffer, or exceed a hard hardware limit.
    ``verify="strict"`` refuses to build an engine on any error.
  * ``warning`` — legal but suspicious: the runtime will silently fall
    back (full-tensor rebuffer, unaligned block clip) and pay for it.
  * ``info``    — a declared fallback the plan is expected to take
    (e.g. token-dim replication on a mesh the slot count doesn't divide).

Every diagnostic names the pass that produced it, the plan stage it
anchors to (``<layer_kind>.<stage>``, ``final.lm_head``,
``dispatch.<name>`` or ``pool.<leaf>``), a stable ``code`` slug the tests
key on, and a fix hint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence

SEVERITIES = ("error", "warning", "info")
PASSES = ("itensor", "kernel", "sharding", "effects", "tuning")


@dataclass(frozen=True)
class Diagnostic:
    severity: str       # "error" | "warning" | "info"
    pass_name: str      # "itensor" | "kernel" | "sharding" | "effects"
    stage: str          # "attn.ffn", "final.lm_head", "dispatch.decode", ...
    code: str           # stable slug, e.g. "non-divisible-block"
    message: str
    fix_hint: str = ""

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")
        if self.pass_name not in PASSES:
            raise ValueError(f"unknown pass {self.pass_name!r}")

    def __str__(self) -> str:
        hint = f" (fix: {self.fix_hint})" if self.fix_hint else ""
        return (f"[{self.severity}] {self.pass_name}:{self.code} "
                f"@ {self.stage}: {self.message}{hint}")


class PlanVerificationError(ValueError):
    """Raised by ``verify="strict"`` when a plan carries error diagnostics."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        errs = [d for d in self.diagnostics if d.severity == "error"]
        lines = "\n  ".join(str(d) for d in errs)
        super().__init__(
            f"StreamPlan failed static verification with {len(errs)} "
            f"error(s):\n  {lines}")


def errors(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == "error"]


def warnings_(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == "warning"]


def clean(diags: Iterable[Diagnostic]) -> bool:
    """No errors and no warnings (info-level notes are fine)."""
    return not any(d.severity in ("error", "warning") for d in diags)
