"""Shared violation/report types for the ``repro_torch.analysis`` passes.

Every pass reports findings as :class:`Violation` records carrying a stable
*named* rule (``"graph/shape-mismatch"``,
``"race/compute-before-copy-ready"`` ...), a human message, and a location:
a node chain for the graph verifier, a ticket chain for the race detector.
Raising paths wrap the list in :class:`AnalysisError` so the rule names
survive into the exception text (tests assert on them).

Stdlib only at module scope.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

__all__ = ["AnalysisError", "Violation", "format_violations"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding of one analysis pass.

    rule    — stable rule name (``<pass>/<invariant>``);
    message — what broke, with enough operands/events to act on;
    where   — location: a ``node#id`` chain for the graph verifier, a
              ticket chain for the race detector.
    """

    rule: str
    message: str
    where: str = ""

    def render(self) -> str:
        loc = f"{self.where}: " if self.where else ""
        return f"{loc}{self.rule}: {self.message}"


def format_violations(violations: Sequence[Violation]) -> str:
    return "\n".join(v.render() for v in violations)


class AnalysisError(Exception):
    """Raised by the ``assert_*`` entry points when violations were found.

    Carries ``flight``: the obs flight recorder's bounded window (last K
    tickets/spans per device) frozen at raise time next to the violations,
    so a failed check ships its own repro trace.
    """

    def __init__(self, violations: Sequence[Violation], header: str) -> None:
        self.violations: List[Violation] = list(violations)
        n = len(self.violations)
        super().__init__(
            f"{header}: {n} violation{'s' if n != 1 else ''}\n"
            + format_violations(self.violations)
        )
        try:
            from repro_torch.obs import flight

            self.flight = flight.capture(self.violations)
        except Exception:       # never mask the analysis failure itself
            self.flight = None
