"""repro_torch.analysis — static analysis for the port (the port of
``repro.analysis``).

Two layers (paper motivation: the §5-§6 placement and write-policy wins
evaporate from a single hidden host wait or dtype widening, so these bug
classes are caught before a benchmark regresses):

  Layer 1 — AST lint, no torch import needed.
    ``rules``       per-module torch-aware rules (host syncs on the hot
                    path, scalars copied to the card, PRNG hygiene, f64);
    ``repo_rules``  cross-file registry-completeness rules (plain
                    versions, parity and card tests, spec sections,
                    topology snapshots, chip_smoke's kernel rows);
    ``baseline``    the ratchet (``analysis/lint_baseline.json``).

  Layer 2 — step auditor (imports torch; import it explicitly):
    ``repro_torch.analysis.step_audit`` records the ops one train step's
    halves and the serve path dispatch for representative presets and
    asserts on them — no f64, no host reads, collectives present/absent
    exactly per MeshCfg/CompressionCfg, and a recompile-hazard count.

Driven by ``python -m repro_torch.analysis`` (``__main__``).  This package
does not import ``step_audit`` here: Layer 1 stays importable, and fast,
where torch never loads.
"""
from repro_torch.analysis.baseline import compare, load_baseline, save_baseline
from repro_torch.analysis.repo_rules import REPO_RULES, lint_repo
from repro_torch.analysis.rules import (COUNTERPARTS, NOT_PORTED, RULES,
                                        Finding, lint_paths, lint_source)

ALL_RULES = {**RULES, **REPO_RULES}

__all__ = ["Finding", "RULES", "REPO_RULES", "ALL_RULES", "COUNTERPARTS",
           "NOT_PORTED", "lint_source", "lint_paths", "lint_repo",
           "load_baseline", "save_baseline", "compare"]
