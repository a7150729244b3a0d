"""Dry-run analysis: per-device counts of a traced step and roofline terms.

Port of `repro.analysis`; `trace` is the counterpart of its `hlo`."""

from repro_torch.analysis.roofline import RooflineTerms, roofline_terms  # noqa: F401
from repro_torch.analysis.trace import StepCounter, Totals  # noqa: F401
