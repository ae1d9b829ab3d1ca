"""Torch-aware lint and step audit for the port (the port of
``tools/lint.py``, which stays the reference's entry point).

Layer 1 (default; no torch import): the AST rules over ``src/repro_torch``
and ``chip_smoke.py`` plus the registry rules, compared against the
committed ratchet baseline (``src/repro_torch/analysis/lint_baseline.json``):
NEW findings fail, FIXED findings must be removed from the baseline
(``--update``), so the recorded debt only ever shrinks.

Layer 2 (``--audit``): the step auditor (``analysis/step_audit.py``) on
the smoke presets.  With ``--mesh 1`` (the default) lightgcn and ngcf on
one device, ngcf with its fused-Hadamard contract; with ``--mesh P`` the
lightgcn arms plain, int8 gradients, top-k gradients and the int8 ring at
P shards, one process per shard under ``torchrun``.

    python -m repro_torch.analysis                    # lint vs baseline
    python -m repro_torch.analysis --check-baseline   # same, explicit
    python -m repro_torch.analysis --update           # rewrite the baseline
    python -m repro_torch.analysis --update-snapshots # rewrite plan_snapshots.json
    python -m repro_torch.analysis --rules            # rule catalogue
    python -m repro_torch.analysis --audit --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.analysis \\
        --audit --mesh 4 --device cpu
    python -m repro_torch.analysis src/repro_torch/eval   # restrict paths
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[3]
BASELINE_PATH = ROOT / "src/repro_torch/analysis/lint_baseline.json"
SNAPSHOT_PATH = ROOT / "src/repro_torch/analysis/plan_snapshots.json"
LINT_ROOTS = ("src/repro_torch", "chip_smoke.py")
# (arch, grads, ring) of the audit's arms at --mesh P > 1
MESH_ARMS = (("lightgcn", "none", "none"), ("lightgcn", "int8", "none"),
             ("lightgcn", "topk", "none"), ("lightgcn", "none", "int8"))


def run_lint(paths: list[str]) -> list:
    from repro_torch.analysis import lint_paths, lint_repo
    targets = [ROOT / p for p in (paths or LINT_ROOTS)]
    findings = lint_paths([p for p in targets if p.exists()], root=ROOT)
    if not paths:  # registry rules are repo-wide, skip when restricted
        findings += lint_repo(ROOT)
    return findings


def report(title: str, failures: list[str], *, ok: str, hint: str) -> int:
    if failures:
        print(f"--- {title}: FAIL ---")
        for f in failures:
            print(f"  {f}")
        print(f"({hint})")
        return 1
    print(ok)
    return 0


def lint_main(args) -> int:
    from repro_torch.analysis import compare, load_baseline, save_baseline
    findings = run_lint(args.paths)
    if args.update:
        n = save_baseline(BASELINE_PATH, findings)
        print(f"wrote {BASELINE_PATH} ({n} baselined finding(s))")
        return 0
    new, stale = compare(findings, load_baseline(BASELINE_PATH))
    failures = [str(f) for f in new]
    failures += [f"stale baseline entry {k!r}: recorded {rec}, "
                 f"now {rem} — shrink the baseline"
                 for k, rec, rem in stale]
    return report(
        "lint (repro_torch.analysis layer 1)", failures,
        ok=f"lint OK ({len(findings)} finding(s), all baselined; "
           f"baseline {BASELINE_PATH.name})",
        hint="new findings: fix them; fixed findings: rerun with "
             "--update and commit the shrunk baseline")


def build_snapshots() -> dict:
    """The placement plans of ``tools/check_plan_snapshot.py``'s build,
    through the port's planner, under every topology the port
    registers."""
    from repro_torch.api import get_preset
    from repro_torch.memory import (get_policy, get_topology,
                                    gnn_recsys_profiles, topology_names)
    spec = get_preset("lightgcn-full")
    arms = {store: gnn_recsys_profiles(
        spec.data.n_users, spec.data.n_items, spec.data.edges,
        spec.model.embed_dim, spec.model.n_layers, embed_store=store)
        for store in ("fp32", "int8")}
    total = sum(p.nbytes for p in arms["fp32"])
    # NGCF with and without the fused Hadamard route, against the same
    # budget (30 % of the unfused footprint)
    nspec = get_preset("ngcf-full")
    ngcf_arms = {"ngcf": gnn_recsys_profiles(
        nspec.data.n_users, nspec.data.n_items, nspec.data.edges,
        nspec.model.embed_dim, nspec.model.n_layers),
        "ngcf-fused": gnn_recsys_profiles(
        nspec.data.n_users, nspec.data.n_items, nspec.data.edges,
        nspec.model.embed_dim, nspec.model.n_layers, fused_messages=True)}
    ngcf_total = sum(p.nbytes for p in ngcf_arms["ngcf"])
    out = {"_profile": {
        "preset": "lightgcn-full",
        "n_tensors": len(arms["fp32"]),
        "total_bytes": int(total),
        "fast_budget_fraction": 0.3,
        "storage_arms": ["fp32", "int8"],
        "ngcf_preset": "ngcf-full",
        "ngcf_n_tensors": {k: len(v) for k, v in ngcf_arms.items()},
        "ngcf_total_bytes": int(ngcf_total),
        "ngcf_arms": sorted(ngcf_arms),
    }}
    for name in topology_names():
        topo = get_topology(name)
        budgets = {topo.fast.name: int(total * 0.3),
                   topo.slow.name: max(topo.slow.capacity, total)}
        for store, profiles in arms.items():
            plan = get_policy("greedy")(profiles, topo, budgets=budgets)
            key = name if store == "fp32" else f"{name}@int8"
            out[key] = plan.to_dict()
        nbudgets = {topo.fast.name: int(ngcf_total * 0.3),
                    topo.slow.name: max(topo.slow.capacity, ngcf_total)}
        for arm, profiles in ngcf_arms.items():
            plan = get_policy("greedy")(profiles, topo, budgets=nbudgets)
            out[f"{name}@{arm}"] = plan.to_dict()
    return out


def audit_main(args) -> int:
    from repro_torch.analysis import step_audit
    if args.mesh <= 1:
        arms = [dict(arch=a) for a in ("lightgcn", "ngcf")]
    else:
        arms = [dict(arch=a, grads=g, ring=r) for a, g, r in MESH_ARMS]
    failures = []
    for arm in arms:
        violations = step_audit.smoke_audit(mesh=args.mesh, device=args.device,
                                            **arm)
        failures += violations
        print(f"  audited mesh={args.mesh} {json.dumps(arm)}: "
              f"{'FAIL' if violations else 'ok'}", flush=True)
    return report(
        "step audit (repro_torch.analysis layer 2)", failures,
        ok=f"step audit OK ({len(arms)} arm(s) at mesh={args.mesh}: train "
           "halves + serve + recompile hazard)",
        hint="a step violated a dtype/host-read/collective invariant — see "
             "src/repro_torch/analysis/step_audit.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help=f"lint roots (default: {', '.join(LINT_ROOTS)})")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the ratchet baseline from current findings")
    ap.add_argument("--check-baseline", action="store_true",
                    help="explicit alias of the default compare mode")
    ap.add_argument("--update-snapshots", action="store_true",
                    help="rewrite the port's golden plan snapshots")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--audit", action="store_true",
                    help="run the step auditor on the smoke presets")
    ap.add_argument("--mesh", type=int, default=1,
                    help="shards for --audit (P > 1: under torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="device for --audit (cpu runs the plain route)")
    args = ap.parse_args(argv)
    if args.rules:
        from repro_torch.analysis import ALL_RULES, NOT_PORTED
        width = max(map(len, {**ALL_RULES, **NOT_PORTED}))
        for name in sorted(ALL_RULES):
            print(f"  {name:<{width}}  {ALL_RULES[name]}")
        for name in sorted(NOT_PORTED):
            print(f"  {name:<{width}}  not ported: {NOT_PORTED[name]}")
        return 0
    if args.update_snapshots:
        snaps = build_snapshots()
        SNAPSHOT_PATH.write_text(json.dumps(snaps, indent=2, sort_keys=True)
                                 + "\n")
        print(f"wrote {SNAPSHOT_PATH} ({len(snaps) - 1} topology/storage "
              "plans)")
        return 0
    if args.audit:
        return audit_main(args)
    return lint_main(args)


if __name__ == "__main__":
    sys.exit(main())
