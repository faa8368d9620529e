"""``repro_torch.analysis`` — the analysis passes over the port's offload
seam, twins of the reference's ``analysis/`` package:

* :mod:`repro_torch.analysis.graph` — pre-dispatch verifier for ``hnp``
  lazy expression graphs (shapes/dtypes against the registry's host
  lowerings on the meta device, residency handle lifetimes, wave-schedule
  RAW/WAR hazards);
* :mod:`repro_torch.analysis.races` — happens-before checker over the
  ``LaunchTicket`` event streams the modeled devices emit, the streaming
  engine's slot refills and the expert-placement migrations;
* :mod:`repro_torch.analysis.lint` — the AST lint over the port's own
  source (``tools/repro_torch_lint.py`` drives it).

Every pass reports :class:`~repro_torch.analysis.base.Violation`
records under the reference's rule names and raises
:class:`~repro_torch.analysis.base.AnalysisError` subclasses from its
``assert_*`` entry points.

Import-light: this package loads no engine at import; the dynamic passes
load it when handed live graphs or clusters.
"""

from repro_torch.analysis.base import AnalysisError, Violation, format_violations

__all__ = ["AnalysisError", "Violation", "format_violations"]
