"""The port's analysis layer (``repro_torch.analysis``) against the
reference's ``repro.analysis``, on the CPU.

Layer 1: ``Finding`` fingerprints equal to the reference's on shared
seeded sources (its numpy PRNG and float64 rules), one bad source and
its clean twin per port rule, the three scalar-to-device sites repaired
in the engine, BERT4Rec and the clip (their old lines are caught, the
live tree has none), the ratchet against the reference's ``compare``,
the registry rules on a broken repo and the live tree, the committed
baseline and plan snapshots.

Layer 2 (``step_audit``): the expectation table and ``recompile_hazard``
equal to the reference's; ``smoke_audit(mesh=1)`` clean for lightgcn and
ngcf, whose fused micro step forms the [E, D] message shape fewer times
than the composed one (the CPU's plain fused route still gathers at that
shape, so the count is relative; the card asserts none); the gloo arms at
P = 2 (plain, int8 gradients, top-k gradients, int8 ring) meeting their
fragments; a seeded float64 intermediate, a seeded ``.item()`` in the
micro step and a seeded all-reduce on a single-device arm each caught.
Host reads issued from the plain versions in ``kernels/ref.py`` are
exempt on the CPU (``PLAIN_SITES``): the card never runs them, and the
card's audit (chip_smoke.py's ``audit`` phase) holds the whole path.
``Pipeline.apply_update`` factored out of ``step_fn`` gives bitwise equal
states."""
from __future__ import annotations

import importlib
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import baseline as jbaseline
from repro.analysis import hlo_audit as jaudit
from repro.analysis import rules as jrules
from repro_torch.analysis import (ALL_RULES, COUNTERPARTS, NOT_PORTED,
                                  REPO_RULES, RULES, compare, lint_paths,
                                  lint_repo, lint_source, load_baseline,
                                  save_baseline)
from repro_torch.analysis import __main__ as lint_cli
from repro_torch.analysis import rules, step_audit
from repro_torch.api import build
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = "float" + "64"


def rules_of(src: str, **kw) -> set[str]:
    return {f.rule for f in lint_source(textwrap.dedent(src), **kw)}


# ------------------------------------------------------ shared with the ref
def _seeded_numpy_source(seed: int) -> str:
    """A module of numpy PRNG and float64 hazards, drawn from a seed."""
    rng = np.random.default_rng(seed)
    legacy = sorted(jrules._LEGACY_NP_RANDOM)
    lines = ["import numpy as np", "", "def f(x, n):"]
    for i in range(8):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            lines.append(f"    a{i} = np.random.{rng.choice(legacy)}(n)")
        elif kind == 1:
            lines.append(f"    a{i} = np.random.default_rng()")
        elif kind == 2:
            lines.append(f"    a{i} = x.astype(float)")
        elif kind == 3:
            lines.append(f"    a{i} = np.zeros(n, dtype='{F64}')")
        else:
            lines.append(f"    a{i} = np.{F64}(n)")
        lines.append(f"    b{i} = np.random.default_rng({i})")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_finding_keys_equal_reference_on_shared_sources(seed):
    """prng-unseeded and f64-explicit: the same fingerprints (rule ::
    path :: stripped line), lines and columns as the reference's."""
    src = _seeded_numpy_source(seed)
    want = [(f.key(), f.line, f.col) for f in
            jrules.lint_source(src, "src/m.py")]
    got = [(f.key(), f.line, f.col) for f in lint_source(src, "src/m.py")]
    assert want and sorted(got) == sorted(want)


def test_compare_equals_reference():
    """The ratchet: equal (new, stale) for equal findings and baseline."""
    src = _seeded_numpy_source(3)
    findings = lint_source(src, "src/m.py")
    base = {findings[0].key(): 1, "gone::src/x.py::y = 1": 2}
    got_new, got_stale = compare(findings, base)
    want_new, want_stale = jbaseline.compare(findings, base)
    assert [f.key() for f in got_new] == [f.key() for f in want_new]
    assert got_stale == want_stale


def test_baseline_round_trip_and_ratchet(tmp_path):
    findings = lint_source(_seeded_numpy_source(1), "src/m.py")
    path = tmp_path / "baseline.json"
    save_baseline(path, findings)
    assert compare(findings, load_baseline(path)) == ([], [])
    new, stale = compare(findings[1:], load_baseline(path))
    assert new == [] and len(stale) == 1


def test_rule_catalogue_covers_the_reference():
    """Each of the reference's nine rules has a counterpart here or a
    reason in NOT_PORTED, and the catalogues are disjoint."""
    assert set(COUNTERPARTS) == set(jrules.RULES)
    for ref_rule, port_rule in COUNTERPARTS.items():
        assert (port_rule in RULES) if port_rule else ref_rule in NOT_PORTED
    assert set(NOT_PORTED) == {"pallas-python-branch",
                               "pallas-nonstatic-grid"}
    assert not set(RULES) & set(REPO_RULES)
    assert ALL_RULES == {**RULES, **REPO_RULES}


# ------------------------------------------------------ one twin per rule
HOT = {"step"}
TWINS = {
    "sync-item": ("""
        def step(x):
            return x.sum().item()
    """, """
        def step(x):
            return x.sum()
    """),
    "sync-host-copy": ("""
        import numpy as np
        def step(x):
            y = x * 2
            return np.asarray(y), y.cpu()
    """, """
        import numpy as np
        def step(x, n: int):
            return np.arange(n), x.shape[0]
    """),
    "sync-host-cast": ("""
        def step(x, w):
            return float(x.sum()) * w
    """, """
        def step(x, n: int, ids: np.ndarray):
            return int(n) + int(len(ids)) + int(x.shape[0]) \\
                + int(x.data_ptr() % 16 == 0) + bool(
                    all(t.data_ptr() % 16 == 0 for t in (x,)))
    """),
    "sync-scalar-to-device": ("""
        import math, torch
        def f(x, lr):
            a = torch.tensor(lr, dtype=torch.float32, device=x.device)
            b = torch.tensor(math.sqrt(2.0), device="cuda")
            return a, b
    """, """
        import math, torch
        def f(x, lr):
            a = torch.full((), lr, dtype=torch.float32, device=x.device)
            b = torch.tensor([1, 2], device=x.device)
            c = torch.tensor(lr, device="cpu")
            return a, b, torch.tensor(3.0)
    """),
    "prng-unseeded": ("""
        import torch
        def f(n, t):
            t.normal_()
            return torch.randn(n), torch.randperm(n), torch.rand_like(t)
    """, """
        import torch
        def f(n, t, gen):
            t.normal_(generator=gen)
            return torch.randn(n, generator=gen), \\
                torch.randperm(n, generator=gen)
    """),
    "prng-key-reuse": ("""
        import numpy as np, torch
        def f(seed):
            a = torch.Generator().manual_seed(seed)
            b = torch.Generator().manual_seed(seed)
            return a, b, np.random.default_rng(seed)
    """, """
        import numpy as np, torch
        def f(seed):
            a = torch.Generator().manual_seed(seed)
            b = torch.Generator().manual_seed(seed + 1)
            return a, b, np.random.default_rng((seed, 2))
    """),
    "f64-dtypeless": ("""
        import numpy as np, torch
        def f(n):
            a = np.zeros(n)
            return torch.from_numpy(a), torch.as_tensor(np.array([0.5]))
    """, """
        import numpy as np, torch
        def f(n):
            a = np.zeros(n, dtype=np.float32)
            b = np.zeros(n)
            b = np.ones(n, np.float32)
            return torch.from_numpy(a), torch.from_numpy(b), \\
                torch.as_tensor(np.zeros(n), dtype=torch.float32)
    """),
    "f64-explicit": (f"""
        import torch
        def f(x):
            return x.double(), x.to(torch.{F64}), torch.double
    """, """
        import torch
        def f(x):
            return x.float(), x.to(torch.float32), "float64 in a string"
    """),
}


def test_every_rule_has_twins():
    assert set(TWINS) == set(RULES)


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_rule_fires_on_bad_and_not_on_clean_twin(rule):
    bad, clean = TWINS[rule]
    assert rule in rules_of(bad, hot=HOT)
    assert rule not in rules_of(clean, hot=HOT)


def test_sync_rules_need_the_hot_path():
    """Outside a HOT_PATH function the per-call host reads are not
    findings (setup and host code read the device freely)."""
    bad = TWINS["sync-item"][0]
    assert "sync-item" in rules_of(bad, hot={"step"})
    assert "sync-item" not in rules_of(bad, hot=set())
    nested = """
        class Pipeline:
            def value_and_grad(self, params, users):
                def inner(p):
                    return p.sum().item()
                return inner(params)
    """
    assert "sync-item" in rules_of(
        nested, path="src/repro_torch/pipeline/engine.py")


def test_hot_path_entries_name_real_functions():
    for entry in rules.HOT_PATH:
        mod, qual = entry.split("::")
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
        assert callable(obj), entry


@pytest.mark.parametrize("old", [
    # the three sites before the repair (engine.py, recsys_models.py,
    # optimizers.py): each is a finding
    "lr = torch.tensor(self.lr_for_epoch(epoch), dtype=torch.float32, "
    "device=self.device)",
    "temp = torch.tensor(math.sqrt(d / h), dtype=torch.float32, "
    "device=x.device)",
    "scale = torch.tensor(float(max_norm), dtype=torch.float32, "
    "device=norm.device)",
])
def test_repaired_sites_were_findings(old):
    src = f"import math, torch\ndef f(self, epoch, d, h, x, max_norm, norm):\n    {old}\n"
    assert rules_of(src) == {"sync-scalar-to-device"}


def test_live_port_has_no_scalar_to_device():
    findings = lint_paths([ROOT / "src/repro_torch", ROOT / "chip_smoke.py"],
                          root=ROOT)
    assert [f for f in findings if f.rule == "sync-scalar-to-device"] == []
    assert [f for f in findings if f.rule.startswith("sync-")] == []


# ------------------------------------------------------------ registries
def _write(root: pathlib.Path, rel: str, text: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))


def test_registry_rules_fire_on_broken_repo(tmp_path):
    _write(tmp_path, "src/repro_torch/kernels/ops.py", """
        def route(impl, t):
            return impl
        def sddmm(a, b, impl=None):
            return a @ b
    """)
    _write(tmp_path, "src/repro_torch/kernels/ref.py", "")
    _write(tmp_path, "tests/test_torch_kernels.py", "")
    _write(tmp_path, "src/repro_torch/api/spec.py", """
        class OrphanCfg:
            pass
        _SECTIONS = {}
    """)
    _write(tmp_path, "src/repro_torch/memory/topology.py", """
        register_topology(TierTopology("ghost", fast=None, slow=None))
    """)
    _write(tmp_path, "src/repro_torch/kernels/_build.py", """
        SIGNATURES = {"lonely": {}}
    """)
    _write(tmp_path, "tests/test_torch_cuda.py", """
        def test_lonely(dev):
            pass
    """)
    _write(tmp_path, "chip_smoke.py", "KERNELS = {}\n")
    got = lint_repo(tmp_path)
    assert {f.rule for f in got} == set(REPO_RULES)
    # route() takes impl without a default: not a dispatch entry
    assert all("`route`" not in f.message for f in got)


def test_registry_rules_skip_missing_surfaces(tmp_path):
    assert lint_repo(tmp_path) == []


def test_live_repo_registries_are_complete():
    assert lint_repo(ROOT) == []


def test_committed_baseline_and_snapshots_are_current(capsys):
    """``python -m repro_torch.analysis --check-baseline`` exits 0, and
    the committed golden plans are what the port's planner builds."""
    assert lint_cli.main(["--check-baseline"]) == 0
    assert "lint OK" in capsys.readouterr().out
    import json
    assert json.loads(lint_cli.SNAPSHOT_PATH.read_text()) == \
        json.loads(json.dumps(lint_cli.build_snapshots()))


def test_port_snapshots_equal_the_references_plans():
    """Every arm of tools/plan_snapshots.json (the reference's topologies)
    is the same plan in the port's golden file; the port adds
    h100-hbm-host's arms."""
    import json
    want = json.loads((ROOT / "tools/plan_snapshots.json").read_text())
    got = json.loads(lint_cli.SNAPSHOT_PATH.read_text())
    for key, plan in want.items():
        assert got[key] == plan, key
    assert set(got) - set(want) == {
        f"h100-hbm-host{s}" for s in ("", "@int8", "@ngcf", "@ngcf-fused")}


# ------------------------------------------------------------ expectations
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("grads", ["none", "int8", "topk"])
@pytest.mark.parametrize("ring", ["none", "int8"])
def test_expectation_for_maps_to_the_reference_fragments(n_shards, grads,
                                                          ring):
    got = step_audit.expectation_for(n_shards=n_shards, grads=grads,
                                     ring=ring)
    want = jaudit.expectation_for(n_shards=n_shards, grads=grads, ring=ring)
    assert (got.name, got.contains, got.absent) == \
        (want.name, want.contains, want.absent)
    assert set(step_audit.FRAGMENTS) == set(jaudit.FRAGMENTS)


class _Plan:
    def __init__(self, mu, growth):
        self.global_microbatch, self.growth = mu, growth

    def microbatches_for_epoch(self, epoch):
        return 1 + self.growth * epoch


@pytest.mark.parametrize("mu,growth,batches", [
    (16, 1, None), (16, 1, [16, 40]), (7, 3, None), (5, 0, [3, 5, 11, 0])])
def test_recompile_hazard_equals_reference(mu, growth, batches):
    plan = _Plan(mu, growth)
    assert step_audit.recompile_hazard(plan, batches=batches) == \
        jaudit.recompile_hazard(plan, batches=batches)


# ------------------------------------------------------------ step audit
@pytest.mark.parametrize("arch", ["lightgcn", "ngcf"])
def test_smoke_audit_single_device_is_clean(arch):
    assert step_audit.smoke_audit(mesh=1, arch=arch, device="cpu") == []


def test_fused_ngcf_forms_the_message_shape_less_often():
    spec = step_audit.smoke_spec(arch="ngcf")
    counts = {}
    for had in ("fused", "composed"):
        run = build(spec.override({"model.hadamard": had}), device="cpu")
        recs = step_audit.record_train_step(run)["micro_step"] \
            .recorder.records
        shape = step_audit.message_shape(run.pipeline.g.n_edges,
                                         spec.model.embed_dim)[1]
        counts[had] = sum(o == (torch.float32, shape)
                          for r in recs for o in r.outputs)
    assert 0 < counts["fused"] < counts["composed"]


def _violations_with(monkeypatch, target, name, wrap):
    monkeypatch.setattr(target, name, wrap(getattr(target, name)))
    return step_audit.audit_spec(step_audit.smoke_spec(), serve=False,
                                 device="cpu")


def test_auditor_catches_seeded_f64_intermediate(monkeypatch):
    from repro_torch.core import bpr
    got = _violations_with(monkeypatch, bpr, "bpr_loss",
                           lambda f: lambda *a, **k: f(*a, **k)
                           .to(torch.float64).to(torch.float32))
    assert any("f64 op" in v and "micro_step" in v for v in got), got


def test_auditor_catches_seeded_item_in_value_and_grad(monkeypatch):
    from repro_torch.pipeline.engine import Pipeline

    def wrap(loss):
        def seeded(self, *a, **k):
            value = loss(self, *a, **k)
            if value.item() != value.item():      # a host read, per call
                raise AssertionError("NaN loss")
            return value
        return seeded

    got = _violations_with(monkeypatch, Pipeline, "loss", wrap)
    assert any("host read" in v and "micro_step" in v
               and "repro_torch/pipeline/engine.py" in v for v in got), got


def test_plain_versions_host_reads_are_the_only_exempt_ones():
    run = build(step_audit.smoke_spec(), device="cpu")
    recs = step_audit.record_train_step(run)["micro_step"].recorder.records
    reads = [r for r in recs if r.host_read]
    assert reads and all(r.site.startswith("repro_torch/kernels/ref.py")
                         for r in reads)
    assert step_audit.check_ops(recs) != []
    assert step_audit.check_ops(
        recs, exempt_sites=step_audit.PLAIN_SITES) == []


MESH_ARMS = [("lightgcn", "none", "none"), ("lightgcn", "int8", "none"),
             ("lightgcn", "topk", "none"), ("lightgcn", "none", "int8")]


def test_gloo_arms_meet_their_fragments(tmp_path):
    """Two gloo ranks: every arm clean, and the collectives each fragment
    names are there (s8 on the int8 ring, s32 under int8 gradients)."""
    out = run_ranks(tmp_path, 2, "step_audit", arms=MESH_ARMS)
    for rank in out:
        for arm, (violations, seen) in rank.items():
            assert violations == [], (arm, violations)
            exp = step_audit.expectation_for(n_shards=2, grads=arm[1],
                                             ring=arm[2])
            assert set(exp.contains) <= set(seen["tokens"]), arm


def test_auditor_catches_seeded_allreduce_on_single_device(tmp_path):
    out = run_ranks(tmp_path, 1, "step_audit",
                    arms=[("lightgcn", "none", "none")], seeded="allreduce")
    (violations, seen), = out[0].values()
    assert any("forbidden 'all-reduce'" in v for v in violations)
    assert seen["collectives"] == {"all-reduce": 1}


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("preset,ov", [
    ("lightgcn-smoke", {}),
    ("lightgcn-smoke", {"compression.grads": "int8"}),
    ("ngcf-smoke", {}),
])
def test_apply_update_equals_the_inline_update(preset, ov, one_torch_thread):
    """step_fn through ``apply_update`` equals compressor-then-optimizer
    written out, bit for bit, on the same fetched state and gradients."""
    from repro_torch.api import get_preset
    from repro_torch.optim.optimizers import tree_leaves
    run = build(get_preset(preset).override(ov), device="cpu")
    pipe = run.pipeline
    state = pipe.executor.fetch(run.state)
    u, p, n = pipe._next_target_batch(1, 0)
    _, grads = pipe.grads_for_batch(state["params"], u, p, n)
    lr = torch.full((), pipe.lr_for_epoch(0), dtype=torch.float32)
    got = pipe.apply_update(state, grads, lr)
    want = {}
    g = grads
    if pipe.compressor is not None:
        g, want["comp"] = pipe.compressor(grads, state["comp"])
    want["params"], want["opt"] = pipe.opt.update(g, state["opt"],
                                                  state["params"], lr=lr)
    assert sorted(got) == sorted(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
