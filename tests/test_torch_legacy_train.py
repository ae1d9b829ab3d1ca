"""The port's legacy trainers (``launch/train.py::train_gcn`` and
``train_recsys``) against the reference's: 20 steps on the reference's
synthetic data, from the reference's initial params (``jax.random`` and
torch draw different numbers, so the reference's init is carried across
through numpy and handed to the trainer), losses within rtol 1e-4; a run
resumed from its checkpoint is bit-exact against the same steps taken in
memory from the checkpointed state, and lands where the reference's
resumed run does; the CLI runs each arch on the CPU and prints the loss
span in the reference's format.  A pipeline run's closing line gives the
reference's accumulation factor where the batch staged for the next
step enters an epoch with another one.

Both packages' trainers resume with a fresh ``default_rng(0)``: the
resumed steps see the first batches again, as the reference's do.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import gcn as jgcn
from repro.models import recsys_models as jrm
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as ttrain
from repro_torch.optim import adam
from repro_torch.optim.optimizers import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-4
STEPS = 20
ARCHS = ["gcn-cora", "deepfm", "xdeepfm", "dlrm_rm2"]
JINIT = {"deepfm": jrm.deepfm_init, "xdeepfm": jrm.xdeepfm_init,
         "dlrm_rm2": jrm.dlrm_init}


def _reference_init(arch):
    """The reference trainer's own init (``jax.random.PRNGKey(0)``), as
    port tensors on the CPU."""
    if arch == "gcn-cora":
        jp = jgcn.init_params(jconfigs.get("gcn_cora").SMOKE,
                              jax.random.PRNGKey(0))
    else:
        jp = JINIT[arch](jconfigs.get(arch).SMOKE, jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _run(arch, steps, ckpt, params=None, package="port"):
    if package == "reference":
        if arch == "gcn-cora":
            return jtrain.train_gcn(steps, ckpt)
        return jtrain.train_recsys(arch, steps, ckpt)
    if arch == "gcn-cora":
        return ttrain.train_gcn(steps, ckpt, device="cpu", params=params)
    return ttrain.train_recsys(arch, steps, ckpt, device="cpu", params=params)


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_matches_reference(arch, tmp_path):
    want = _run(arch, STEPS, str(tmp_path / "ref"), package="reference")
    got = _run(arch, STEPS, str(tmp_path / "port"), _reference_init(arch))
    assert got.steps_run == want.steps_run == STEPS
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)


def _continue_in_memory(arch, state, n):
    """``n`` steps of the trainer's step from ``state`` with the batches a
    resumed run draws (a fresh ``default_rng(0)``), without a checkpoint."""
    from repro_torch import configs
    from repro_torch.core.graph import from_numpy
    losses = []
    if arch == "gcn-cora":
        cfg = configs.get("gcn_cora").SMOKE
        rng = np.random.default_rng(0)
        src = rng.integers(0, 200, 1600).astype(np.int32)
        dst = rng.integers(0, 200, 1600).astype(np.int32)
        g = from_numpy(src, dst, 200, device="cpu")
        x = torch.from_numpy(rng.standard_normal((200, cfg.d_feat))
                             .astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, cfg.n_classes, 200)
                                  .astype(np.int32))
        step = ttrain.gcn_train_step(cfg, g, x, labels, torch.ones(200),
                                     adam(1e-2))
        for _ in range(n):
            state, loss = step(state)
            losses.append(float(loss))
        return state, losses
    cfg = configs.get(arch).SMOKE
    rng = np.random.default_rng(0)
    step = ttrain.recsys_train_step(arch, cfg, adam(1e-3))
    for _ in range(n):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab, (256, cfg.n_sparse))
                               .astype(np.int32))
        labels = torch.from_numpy(rng.integers(0, 2, 256).astype(np.float32))
        feats = [ids]
        if arch == "dlrm_rm2":
            feats = [torch.from_numpy(rng.standard_normal((256, cfg.n_dense))
                                      .astype(np.float32)), ids]
        state, loss = step(state, *feats, labels)
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_resumed_run_is_bit_exact(arch, tmp_path):
    ckpt = str(tmp_path / "port")
    first = _run(arch, STEPS // 2, ckpt, _reference_init(arch))
    resumed = _run(arch, STEPS, ckpt, _reference_init(arch))
    assert resumed.resumed_from == STEPS // 2
    state, losses = _continue_in_memory(arch, first.final_state, STEPS // 2)
    assert resumed.losses == losses
    for a, b in zip(tree_leaves(resumed.final_state),
                    tree_leaves(state)):
        assert torch.equal(a, b)
    # and the reference's resumed run lands where the port's does
    jckpt = str(tmp_path / "ref")
    _run(arch, STEPS // 2, jckpt, package="reference")
    jresumed = _run(arch, STEPS, jckpt, package="reference")
    assert jresumed.resumed_from == STEPS // 2
    np.testing.assert_allclose(resumed.losses, jresumed.losses,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_runs_legacy_trainer_on_cpu(arch, tmp_path, capsys):
    ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    name = "gcn" if arch == "gcn-cora" else arch
    assert re.fullmatch(rf"\[{name}\] loss \d+\.\d{{4}} -> \d+\.\d{{4}}",
                        out[-1]), out


# quickstart runs 28 steps an epoch of one 256-row microbatch for two
# warm-up epochs, then 7 steps of four: 56 steps end warm-up exactly.  At
# 32-row microbatches and one warm-up epoch, warm-up steps take four and
# step 56 crosses into the first epoch of 32.
CLOSING_CASES = {
    "warmup_ends_with_the_run": [],
    "next_step_crosses_out_of_warmup": ["--set", "plan.microbatch=32",
                                        "--set", "plan.warmup_epochs=1"],
}


@pytest.mark.parametrize("case", sorted(CLOSING_CASES))
def test_closing_line_gives_the_reference_accumulation(case, tmp_path,
                                                       monkeypatch):
    """The closing line's ``accum`` is the reference's, although the
    port's loader stands a step ahead (the next step's batch is staged)
    and that step draws at another accumulation factor."""
    import contextlib
    import io
    runs = []
    build = ttrain.Experiment.build

    def keep(self, *a, **kw):
        runs.append(build(self, *a, **kw))
        return runs[-1]

    monkeypatch.setattr(ttrain.Experiment, "build", keep)
    lines = {}
    for name, mod, kw in (("reference", jtrain, {}),
                          ("port", ttrain, {"device": "cpu"})):
        args = mod.build_arg_parser().parse_args(
            ["--preset", "quickstart", "--steps", "56", "--ckpt-dir",
             str(tmp_path / name)] + CLOSING_CASES[case])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.run_experiment(mod.spec_from_args(args), **kw)
        lines[name] = [ln for ln in out.getvalue().splitlines()
                       if " steps in " in ln]
    accum = {name: re.findall(r"accum=(\d+)x", ln[0])
             for name, ln in lines.items()}
    assert accum["port"] == accum["reference"], lines
    pipe = runs[0].pipeline
    assert pipe.plan.microbatches_for_epoch(pipe.loader.state.epoch) != \
        int(accum["reference"][0])          # the loader reads a step ahead


@pytest.mark.parametrize("arch", ["gemma2_2b", "kimi_k2_1t_a32b"])
def test_lm_arch_message_names_a_dry_run_that_runs(arch, tmp_path):
    """The launcher ends an LM arch naming ``python -m
    repro_torch.launch.dryrun --arch <arch> --shape <shape>`` and the
    shapes; that command, with each named shape, writes its record."""
    import json
    from repro_torch.launch import dryrun
    with pytest.raises(SystemExit) as got:
        ttrain.main(["--arch", arch, "--steps", "1", "--device", "cpu"])
    msg = str(got.value)
    m = re.search(r"python -m repro_torch\.launch\.dryrun --arch (\S+) "
                  r"--shape <shape>, <shape> one of ([\w, ]+)\)$", msg)
    assert m and m.group(1) == arch, msg
    shapes = m.group(2).split(", ")
    assert shapes == [s for s in jconfigs.get(arch).SHAPES
                      if s not in jconfigs.get(arch).SKIP]
    for shape in shapes:
        assert dryrun.main(["--arch", m.group(1), "--shape", shape,
                            "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / f"{arch}__{shape}__one-card.json")
                         .read_text())
        assert rec["arch"] == arch and rec["shape"] == shape
