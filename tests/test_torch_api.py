"""The port's Experiment API on the CPU against the reference's: specs key
for key (every preset, a spec with every section non-default, JSON round
trips, dotted overrides, the same errors), the preset and architecture
registries, the data sources, the launcher's flags, and ``Run`` itself —
``fit()`` on ``lightgcn-smoke`` and ``quickstart`` along the reference's
loss trajectory from the reference's init (carried across through numpy,
as ``tests/test_torch_train.py`` does), ``evaluate()``, ``recommend()``,
a bit-exact resume, and a reference checkpoint resumed in the port."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api import Experiment as JExperiment
from repro.api import ExperimentSpec as JExperimentSpec
from repro.api import build as jbuild
from repro.api import get_preset as jget_preset
from repro.api import load_data as jload_data
from repro.api import preset_names as jpreset_names
from repro.api.spec import CompressionCfg as JCompressionCfg
from repro.api.spec import DataCfg as JDataCfg
from repro.api.spec import ServeCfg as JServeCfg
from repro.launch import train as jtrain
from repro_torch import configs
from repro_torch.api import (CompressionCfg, DataCfg, EvalCfg, Experiment,
                             ExperimentSpec, LoopCfg, MemoryCfg, MeshCfg,
                             ModelCfg, PlanCfg, ServeCfg, build, get_preset,
                             load_data, preset_names)
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as ttrain
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_torch_train.py's trajectory tolerances
LOSS_RTOL = 1e-4
SGD_RTOL, SGD_ATOL = 1e-4, 1e-6


def _flat(tree, prefix=""):
    """{path: numpy array} over nested dicts/lists (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _full_spec_kwargs():
    """Every section away from its defaults (valid in both packages)."""
    return dict(
        name="every-section",
        model=dict(arch="ngcf", embed_dim=64, n_layers=3, hadamard="composed"),
        data=dict(source="kronecker", dataset="gowalla", edges=1000,
                  n_users=10, n_items=20, expand_factor=4, test_frac=0.2,
                  seed=7),
        plan=dict(hbm_budget=1 << 20, target_batch=4096, microbatch=None,
                  base_batch=128, warmup_epochs=1, lr_scaling="sqrt",
                  impl="torch"),
        mesh=dict(shape=(2, 2), axes=("data", "model"), spmm="ring",
                  ring_steps=1),
        memory=dict(topology="h100-hbm-host", policy="paper-recipe",
                    capacity={"fast": 1 << 30}, pins={"item_embed": "slow"}),
        compression=dict(grads="topk", frac=0.05, error_feedback=False,
                         embed_store="int8", ring="int8"),
        loop=dict(steps=17, ckpt_dir="ck", ckpt_every=3, eval_every=5,
                  step_deadline_s=1.5, max_strays=2, async_ckpt=True),
        eval=dict(k=10, user_batch=64, item_block=256),
        serve=dict(cache_rows=128, fused=False, ann=True, keep_frac=0.25,
                   queue_max_batch=16, queue_max_wait_us=500),
        optimizer="sgd", base_lr=0.05, l2=0.0, seed=3)


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("name", jpreset_names())
def test_preset_spec_equals_reference(name):
    assert get_preset(name).to_dict() == jget_preset(name).to_dict()
    assert Experiment.from_preset(name).to_dict() == \
        JExperiment.from_preset(name).to_dict()


def test_preset_names_equal_reference():
    """The reference's GNNRecSys presets (ngcf/lightgcn x full/smoke) plus
    quickstart, and nothing else."""
    assert preset_names() == jpreset_names()
    assert set(preset_names()) == {"ngcf-full", "ngcf-smoke",
                                   "lightgcn-full", "lightgcn-smoke",
                                   "quickstart"}


def test_every_section_non_default_equals_reference():
    d = _full_spec_kwargs()
    spec = ExperimentSpec.from_dict(d)
    jspec = JExperimentSpec.from_dict(d)
    assert spec.to_dict() == jspec.to_dict()
    for section in ("model", "data", "plan", "mesh", "memory", "compression",
                    "loop", "eval", "serve"):
        assert getattr(spec, section) != getattr(ExperimentSpec(), section)
    assert ExperimentSpec().to_dict() == JExperimentSpec().to_dict()
    # the JSON round trip in either direction
    assert ExperimentSpec.from_json(jspec.to_json()) == spec
    assert JExperimentSpec.from_json(spec.to_json()).to_dict() == \
        spec.to_dict()
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    cfg = spec.to_pipeline_config()
    jcfg = jspec.to_pipeline_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_spec_file_round_trip_and_overrides(tmp_path):
    spec = get_preset("lightgcn-smoke")
    path = str(tmp_path / "spec.json")
    spec.save(path)
    assert ExperimentSpec.from_file(path) == spec
    assert JExperimentSpec.from_file(path).to_dict() == spec.to_dict()
    ov = {"model.embed_dim": 64, "plan.microbatch": 16, "mesh.shape": (4,),
          "memory.pins": {"user_embed": "slow"}, "serve.keep_frac": 0.5}
    got = spec.override(ov, optimizer="sgd")
    want = jget_preset("lightgcn-smoke").override(ov, optimizer="sgd")
    assert got.to_dict() == want.to_dict()
    assert got.model.arch == spec.model.arch


def _raises(fn):
    try:
        fn()
    except Exception as e:              # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    "unknown_key", "unknown_section_key", "section_not_mapping",
    "unknown_override", "bad_hadamard", "bad_ring_steps", "bad_grads",
    "bad_frac", "bad_embed_store", "bad_ring", "bad_cache_rows",
    "bad_keep_frac", "bad_queue_batch", "bad_queue_wait"])
def test_bad_specs_raise_as_the_reference(case):
    """Unknown keys and bad values raise the reference's exception with
    the reference's message."""
    bad = {
        "unknown_key": {"modle": {}},
        "unknown_section_key": {"model": {"embed_dims": 64}},
        "section_not_mapping": {"plan": 3},
        "bad_hadamard": {"model": {"hadamard": "bogus"}},
        "bad_ring_steps": {"mesh": {"ring_steps": 0}},
        "bad_grads": {"compression": {"grads": "fp8"}},
        "bad_frac": {"compression": {"frac": 0.0}},
        "bad_embed_store": {"compression": {"embed_store": "bf16"}},
        "bad_ring": {"compression": {"ring": "topk"}},
        "bad_cache_rows": {"serve": {"cache_rows": -1}},
        "bad_keep_frac": {"serve": {"keep_frac": 1.5}},
        "bad_queue_batch": {"serve": {"queue_max_batch": 0}},
        "bad_queue_wait": {"serve": {"queue_max_wait_us": -1}},
    }
    if case == "unknown_override":
        got = _raises(lambda: get_preset("quickstart").override(
            {"model.width": 64}))
        want = _raises(lambda: jget_preset("quickstart").override(
            {"model.width": 64}))
    else:
        got = _raises(lambda: ExperimentSpec.from_dict(bad[case]))
        want = _raises(lambda: JExperimentSpec.from_dict(bad[case]))
    assert want is not None and got == want


def test_section_coercions_equal_reference():
    for t, j, kw in [(ServeCfg, JServeCfg, dict(cache_rows=3.0, fused=1,
                                                 ann=0, keep_frac=1)),
                     (CompressionCfg, JCompressionCfg,
                      dict(frac=1, error_feedback=0)),
                     (DataCfg, JDataCfg, dict(edges=10))]:
        assert dataclasses.asdict(t(**kw)) == dataclasses.asdict(j(**kw))
    mesh = MeshCfg(shape=[2, "2"], axes=["a", "b"])
    assert mesh.shape == (2, 2) and mesh.axes == ("a", "b")
    assert MemoryCfg(capacity={"fast": "7"}).capacity == {"fast": 7}
    assert LoopCfg().async_ckpt is False and EvalCfg().k == 20
    assert ModelCfg().hadamard == "auto" and PlanCfg().microbatch is None


# --------------------------------------------------------------- registry
def test_config_registry_matches_reference():
    for arch in configs.ARCH_IDS:
        mod, jmod = configs.get(arch), jconfigs.get(arch)
        for attr in ("FAMILY", "OPTIMIZER"):
            assert getattr(mod, attr) == getattr(jmod, attr)
        for variant in ("FULL", "SMOKE"):
            assert dataclasses.asdict(getattr(mod, variant)) == \
                dataclasses.asdict(getattr(jmod, variant))
    assert set(configs.ARCH_IDS) == set(jconfigs.PAPER_OWN)
    for arch in jconfigs.ASSIGNED:
        with pytest.raises(KeyError, match="A12"):
            configs.get(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("nope")


@pytest.mark.parametrize("cfg", [
    dict(source="synth", dataset="gowalla", edges=1000, test_frac=0.1),
    dict(source="bipartite", n_users=40, n_items=30, edges=300,
         test_frac=0.0),
    dict(source="bipartite", n_users=64, n_items=48, edges=512, seed=3),
    dict(source="kronecker", dataset="movielens-10m", edges=500,
         expand_factor=4, test_frac=0.2, seed=1),
    dict(source="kronecker", dataset="amazon-book", edges=300,
         expand_factor=1)], ids=["synth", "bipartite-all", "bipartite",
                                 "kronecker", "kronecker-x1"])
def test_load_data_equals_reference(cfg):
    got, want = load_data(DataCfg(**cfg)), jload_data(JDataCfg(**cfg))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert (a.n_users, a.n_items) == (b.n_users, b.n_items)
        for f in ("user", "item"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_unknown_data_source_raises():
    with pytest.raises(KeyError, match="unknown data source"):
        load_data(DataCfg(source="nope"))


# -------------------------------------------------------------------- CLI
ARGVS = {
    "flags": ["--arch", "ngcf", "--embed-dim", "64", "--layers", "3",
              "--dataset", "gowalla", "--edges", "9000", "--target-batch",
              "4096", "--microbatch", "0", "--steps", "7", "--eval-every",
              "0", "--eval-k", "10", "--ckpt-dir", "ck"],
    "preset_set": ["--preset", "lightgcn-smoke", "--set",
                   "plan.hbm_budget=4096", "--set", "name=renamed",
                   "--ckpt-dir", "ck"],
    "mesh": ["--preset", "lightgcn-smoke", "--mesh", "2x2", "--ring-steps",
             "2", "--spmm", "ring", "--ckpt-dir", "ck"],
    "memory_compression": ["--preset", "quickstart", "--memory-topology",
                           "h100-hbm-host", "--placement-policy",
                           "paper-recipe", "--pin", "item_embed=slow",
                           "--compress-grads", "topk", "--compress-frac",
                           "0.1", "--embed-store", "int8", "--compress-ring",
                           "int8", "--ckpt-dir", "ck"],
    "set_arch": ["--preset", "quickstart", "--set", "model.arch=ngcf",
                 "--set", "loop.ckpt_dir=explicit"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_spec_from_args_equals_reference(name, tmp_path):
    argv = ARGVS[name]
    spec = ttrain.spec_from_args(ttrain.build_arg_parser().parse_args(argv))
    jspec = jtrain.spec_from_args(jtrain.build_arg_parser().parse_args(argv))
    assert spec.to_dict() == jspec.to_dict()
    args = ttrain.build_arg_parser().parse_args(argv)
    assert args.device == "cuda"          # the card unless asked otherwise


def test_spec_from_args_default_ckpt_dir_and_spec_file(tmp_path):
    """Without --ckpt-dir the checkpoints go under the temp directory, as
    the reference's do under /tmp; a --spec file reads as the reference's."""
    spec = ttrain.spec_from_args(ttrain.build_arg_parser().parse_args(
        ["--arch", "lightgcn"]))
    jspec = jtrain.spec_from_args(jtrain.build_arg_parser().parse_args(
        ["--arch", "lightgcn"]))
    assert spec.loop.ckpt_dir == f"{ttrain.DEFAULT_CKPT_ROOT}/lightgcn"
    assert dataclasses.replace(spec.loop, ckpt_dir=None) == \
        dataclasses.replace(spec.loop, **{
            k: v for k, v in dataclasses.asdict(jspec.loop).items()
            if k != "ckpt_dir"}, ckpt_dir=None)
    assert spec.override({"loop.ckpt_dir": None}).to_dict() == \
        jspec.override({"loop.ckpt_dir": None}).to_dict()
    path = str(tmp_path / "s.json")
    get_preset("ngcf-smoke").save(path)
    argv = ["--spec", path, "--steps", "3", "--ckpt-dir", "ck"]
    assert ttrain.spec_from_args(
        ttrain.build_arg_parser().parse_args(argv)).to_dict() == \
        jtrain.spec_from_args(
            jtrain.build_arg_parser().parse_args(argv)).to_dict()


@pytest.mark.parametrize("arch,item", [("gcn-cora", "A11"),
                                       ("deepfm", "A12"),
                                       ("dlrm_rm2", "A12")])
def test_legacy_trainers_raise_naming_their_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "1"])


def test_cli_quickstart_runs_on_cpu(tmp_path, capsys):
    ttrain.main(["--device", "cpu", "--preset", "lightgcn-smoke", "--steps",
                 "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("Run[lightgcn-smoke] arch=lightgcn")
    assert "[lightgcn] 2 steps" in out and "final held-out" in out


# ------------------------------------------------------------------- runs
def _from_reference_init(run, jrun):
    """The port's run restarted from the reference's initial params, with
    a fresh optimizer state (as the reference's own init has)."""
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jrun.state["params"]), "cpu")
    run.state = {"params": params, "opt": run.pipeline.opt.init(params)}


def _masked(text):
    """``describe()`` lines with the kernel route's token masked: the
    port names its own (torch/cuda), the reference pallas/xla."""
    return [" ".join("impl=*" if w.startswith("impl=") else w
                     for w in line.split(" ")) for line in text.splitlines()]


@pytest.mark.parametrize("name", ["lightgcn-full", "ngcf-full"])
def test_full_presets_build_with_the_reference_microbatch(name):
    """The ``*-full`` presets leave the microbatch to the planner and
    build as they are, here on the smoke's small graph: the reference's
    derived microbatch (150,528, the target batch, on the 16 GiB fast
    tier of ``tpu-hbm-host``) and eval batch (4,096, the cap), and its
    ``Run.describe()`` but for the ``impl=`` token."""
    train, test = load_data(get_preset("lightgcn-smoke").data)
    run = Experiment.from_preset(name).build(train=train, holdout=test,
                                             device="cpu")
    jrun = JExperiment.from_preset(name).build(train=train, holdout=test)
    assert run.pipeline.plan.microbatch == jrun.pipeline.plan.microbatch \
        == 150_528
    assert run.pipeline.eval_user_batch() == \
        jrun.pipeline.eval_user_batch() == 4096
    assert _masked(run.describe()) == _masked(jrun.describe())
    assert "impl=torch" in run.describe().splitlines()[1]


@pytest.mark.parametrize("preset,steps", [("lightgcn-smoke", 20),
                                          ("quickstart", 120)])
def test_fit_follows_reference_trajectory(preset, steps):
    """``Run.fit()`` against the reference's from the reference's init:
    every loss within rtol 1e-4; SGD's params to rtol 1e-4 / atol 1e-6;
    Adam's to 1e-5 except at most 0.5 % of elements, each within steps x
    2 x lr (tests/test_torch_train.py's rules).  Then ``evaluate()``
    within the loss tolerance, and ``recommend()`` on the reference's
    final state gives the reference's ids."""
    jrun = jbuild(jget_preset(preset))
    run = build(get_preset(preset), device="cpu")
    assert run.describe().splitlines()[0] == jrun.describe().splitlines()[0]
    _from_reference_init(run, jrun)
    jrep = jrun.fit()
    rep = run.fit()
    assert rep.steps_run == jrep.steps_run == steps
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_RTOL)
    got, want = _flat(run.params), _flat(jax.tree.map(np.asarray,
                                                      jrun.params))
    assert sorted(got) == sorted(want)
    spec = get_preset(preset)
    for k in want:
        if spec.optimizer == "sgd":
            np.testing.assert_allclose(got[k], want[k], rtol=SGD_RTOL,
                                       atol=SGD_ATOL, err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        assert (diff > 1e-5).mean() <= 0.005, (k, diff.max())
        assert diff.max() <= steps * 2 * spec.base_lr, (k, diff.max())
    m, jm = run.evaluate(), jrun.evaluate()
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    # recommend() on the same (the reference's final) embeddings
    run.state = {"params": params_from_jax(
        jax.tree.map(np.asarray, jrun.params), "cpu"),
        "opt": run.state["opt"]}
    run._recommender = None
    users = np.arange(0, run.train_data.n_users, 3)
    ids, scores = run.recommend(users)
    jids, jscores = jrun.recommend(users)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-5,
                               atol=1e-6)


def test_resumed_run_equals_uninterrupted(tmp_path):
    """fit 4 with checkpoints, then a fresh run's resume + fit 4: every
    loss and every state leaf equal to an uninterrupted 8-step run bit for
    bit; fit() on the checkpoint directory resumes the same way."""
    spec = get_preset("quickstart").override({"loop.steps": 8})
    ck = str(tmp_path / "ck")
    straight = build(spec, device="cpu")
    srep = straight.fit()
    first = build(spec, device="cpu")
    rep1 = first.fit(steps=4, ckpt_dir=ck)
    assert rep1.losses == srep.losses[:4]
    resumed = build(spec, device="cpu").resume(ck)
    assert resumed.step_count == 4
    rep2 = resumed.fit(steps=4)
    assert rep2.losses == srep.losses[4:]
    for a, b in ((resumed, straight),):
        fa, fb = _flat(a.state), _flat(b.state)
        assert sorted(fa) == sorted(fb)
        for k in fb:
            assert fa[k].dtype == fb[k].dtype and \
                fa[k].shape == fb[k].shape and \
                fa[k].tobytes() == fb[k].tobytes(), k
    again = build(spec, device="cpu")
    rep3 = again.fit(steps=8, ckpt_dir=ck)
    assert rep3.resumed_from == 4 and rep3.losses == srep.losses[4:]


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint the reference's ``Run.fit`` wrote (lightgcn-smoke,
    Adam: params and {"m", "v", "t"}) restores into the port's state
    leaf for leaf, and the port's next 6 steps follow the reference's
    uninterrupted run within the loss tolerance."""
    spec = get_preset("lightgcn-smoke").override({"loop.steps": 12})
    ck = str(tmp_path / "jck")
    jfirst = jbuild(JExperimentSpec.from_dict(spec.to_dict()))
    jfirst.fit(steps=6, ckpt_dir=ck)
    jstraight = jbuild(JExperimentSpec.from_dict(spec.to_dict()))
    jrep = jstraight.fit()
    run = build(spec, device="cpu").resume(ck)
    assert run.step_count == 6
    got = _flat(run.state)
    want = _flat(jax.tree.map(np.asarray, jfirst.state))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape and \
            got[k].tobytes() == want[k].tobytes(), k
    assert run.state["opt"]["t"].dtype == torch.int32
    rep = run.fit(steps=6)
    np.testing.assert_allclose(rep.losses, jrep.losses[6:], rtol=LOSS_RTOL)


def test_eval_every_step_and_holdoutless_run():
    spec = get_preset("lightgcn-smoke").override({"loop.eval_every": 2})
    run = build(spec, device="cpu")
    assert run.pipeline.shard is None
    assert run.pipeline.out_dim() == 16
    assert run.steps_for_epochs(2) == run.pipeline.steps_for_epochs(2)
    first = run.step()
    report = run.fit(steps=4)
    assert np.isfinite(first) and report.steps_run == 4
    assert [s for s, _ in report.eval_history] == [2, 4]
    assert report.eval_history[-1][1] == run.evaluate()
    bare = build(spec.override({"data.test_frac": 0.0}), device="cpu")
    assert bare.holdout is None and bare.pipeline.eval_fn is None
    with pytest.raises(RuntimeError, match="no holdout"):
        bare.evaluate()


def test_service_answers_like_recommend():
    from repro_torch.serving import ManualClock
    run = build(get_preset("lightgcn-smoke"), device="cpu")
    run.fit(steps=2)
    clock = ManualClock()
    svc = run.service(clock=clock)
    assert svc.rec.k == 20
    for u in (0, 5, 9):
        svc.submit(u)
    responses = svc.drain()
    ids, _ = run.recommend([r.user_id for r in responses])
    for r, row in zip(responses, ids):
        np.testing.assert_array_equal(r.ids, row)


def test_build_defaults_to_the_card(monkeypatch):
    """Without ``device`` a run goes to the card, and raises where there
    is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build(get_preset("lightgcn-smoke"))
    with pytest.raises(RuntimeError, match="cuda"):
        Experiment.from_preset("lightgcn-smoke").run(steps=1)
