"""The runner of every training mix (``"kind": "train"``).

Set-up generates the graph, builds one ``Run`` through the Experiment API
with the configuration's and the mix's overrides, and drives it through
its first ``follow_steps`` steps with ``Run.fit``, reading the losses,
the first gradient (Adam's first moment after one step) and the change
of the parameters; then ``warm_steps`` more.  The window drives the same
``Run`` with ``Run.fit(steps=<one epoch>)`` until ``--seconds`` have
passed, and ends with the epoch that passes it: every chunk holds one of
the loader's per-epoch permutations, and the window whole epochs' work.
A traced run records a span around every ``Pipeline.step_fn`` call of
the window (synchronised at its end), then profiles ``trace_seconds``
more of steps with the operations' calls recorded.  Last, the same
``Run`` takes ``end_steps`` more steps with one ``Run.fit`` call from
the state the window left, copied to the host first.  After that the
program is freed; the reference follows the first steps from the seed,
and the end steps from that copy of the program's state.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from perfbench import reference, rooflines
from perfbench.harness import check, program, trace as tracing
from perfbench.harness.context import Context
from perfbench.harness.outcome import Outcome, log
from perfbench.harness.record import OpRecorder, Spans
from perfbench.reference import graph as ref_graph
from perfbench.reference import train as ref_train


def _norms(tree) -> dict:
    return {n: float(t.detach().double().norm())
            for n, t in ref_train.leaves(tree)}


def first_steps(r, follow: int):
    """Drive ``r`` through its first ``follow`` steps with ``Run.fit`` (the
    window's own call and feed): (losses, the first gradient's norm per
    leaf from Adam's first moment after one step, the norm of each
    leaf's change over the steps)."""
    p0 = [t.detach().clone() for _, t in ref_train.leaves(r.params)]
    losses = list(r.fit(steps=1).losses)
    grad_norms = {n: v / (1 - ref_train.B1)
                  for n, v in _norms(r.state["opt"]["m"]).items()}
    losses += r.fit(steps=follow - 1).losses
    change = {n: float((t.detach() - a).double().norm()) for (n, t), a
              in zip(ref_train.leaves(r.params), p0)}
    return losses, grad_norms, change


@dataclasses.dataclass
class EndSteps:
    """The last steps of a run, from the state the window left: that
    state on the host (the params as a tree, Adam's moments in ``leaves``
    order, its step count, the index of the first step), the steps'
    losses and the norm of each leaf's change over them."""
    step: int
    t: int
    params: dict
    moments: tuple
    losses: list
    change: dict


def end_steps(r, n: int) -> EndSteps:
    """Copy ``r``'s state to the host, then drive ``n`` more steps with
    one ``Run.fit`` call."""
    def host(tree):
        return [t.detach().to("cpu", copy=True)
                for _, t in ref_train.leaves(tree)]
    st = r.state
    before = host(st["params"])
    params = ref_train.unflatten(st["params"], before)
    moments = (host(st["opt"]["m"]), host(st["opt"]["v"]))
    t, step = int(st["opt"]["t"]), int(r.step_count)
    losses = list(r.fit(steps=n).losses)
    change = {name: float((x.detach().cpu().double() - b.double()).norm())
              for (name, x), b in zip(ref_train.leaves(r.params), before)}
    return EndSteps(step, t, params, moments, losses, change)


def reference_follow(cfg: dict, mix: dict, inputs, seed: int, device,
                     precision: str = "float32",
                     end: EndSteps | None = None) -> ref_train.Follow:
    """The reference's own first steps from the generator's train edges,
    the configuration and the seed; or, given ``end``, its steps from
    that state of the program."""
    arch = reference.model(cfg["arch"])
    rg = ref_graph.Graph(torch.from_numpy(inputs.train_user).to(device),
                         torch.from_numpy(inputs.train_item).to(device),
                         inputs.n_users, inputs.n_items)
    if end is None:
        params = arch.init(seed, inputs.n_users, inputs.n_items,
                           cfg["embed_dim"], cfg["n_layers"], device)
        start = {"steps": int(mix["follow_steps"])}
    else:
        params = end.params
        start = {"steps": len(end.losses), "moments": end.moments,
                 "t0": end.t, "step0": end.step}
    ref = ref_train.follow(arch, params, rg, inputs.train_user,
                           inputs.train_item, n_layers=cfg["n_layers"],
                           batch_size=cfg["bpr_batch"], lr=mix["lr"],
                           l2=cfg["l2"], seed=seed, precision_name=precision,
                           **start)
    program.sync(device)
    return ref


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    """One run of the cell; ``t_start`` is the process's start on the
    ``time.perf_counter`` clock (``setup_s`` counts from it)."""
    cfg, mix = cell.config, cell.mix
    inputs = program.make_inputs(cfg, seed, device)
    r = program.build_run(cfg, mix, seed, inputs, device)
    pipe = r.pipeline
    rows = pipe.plan.microbatches_for_epoch(0) * pipe.plan.global_microbatch
    log(plan=pipe.plan.describe().replace("\n", " | "))

    losses, grad_norms, change = first_steps(r, int(mix["follow_steps"]))
    if mix.get("warm_steps", 0):
        r.fit(steps=int(mix["warm_steps"]))
    program.sync(device)
    setup_s = time.perf_counter() - t_start

    spans = Spans(lambda: program.sync(device))
    if traced:
        pipe.step_fn = spans.wrap(pipe.step_fn)
    link0 = dict(pipe.executor.link_bytes)
    chunk = r.steps_for_epochs(1)
    steps = failed = 0
    chunk_s = []
    t0 = time.perf_counter()
    while True:
        rep = r.fit(steps=chunk)
        steps += chunk
        failed += sum(not math.isfinite(x) for x in rep.losses)
        chunk_s.append(time.perf_counter() - t0 - sum(chunk_s))
        if time.perf_counter() - t0 >= seconds:
            break
    program.sync(device)
    t1 = time.perf_counter()
    window_s = t1 - t0
    link = {k: v - link0[k] for k, v in pipe.executor.link_bytes.items()}
    counters = {"link_h2d": link["h2d"], "link_d2h": link["d2h"],
                "tiers_used": pipe.executor.has_demotions,
                "rows_per_step": rows}
    if traced:
        del pipe.step_fn                # the class's method again

    summary, ops, trace_steps = None, None, 0
    if traced:
        summary, ops, trace_steps = _traced_phase(r, mix, device,
                                                   window_s / steps)
    end = end_steps(r, int(mix["end_steps"]))
    peak = program.peak_bytes(device)
    flops = rooflines.module(f"{cfg['arch']}_train_step").flops(
        inputs.n_users, inputs.n_items, len(inputs.train_user),
        cfg["embed_dim"], cfg["n_layers"], rows)
    ctx = Context(cell, window_s, steps, spans.within(t0, t1), counters,
                  summary, trace_steps, ops, flops * steps)
    del r, pipe, rep
    program.free(device)

    t_ref = time.perf_counter()
    ref = reference_follow(cfg, mix, inputs, seed, device)
    ref_end = reference_follow(cfg, mix, inputs, seed, device, end=end)
    numbers = check.train_numbers(losses, grad_norms, change, ref,
                                  abs(rows - cfg["bpr_batch"]))
    numbers.update(check.end_numbers(end.losses, end.change, ref_end))
    correct, checks = check.judge(numbers, cell.limits)
    samples = steps * rows
    return Outcome(
        correct=correct and failed == 0, attempted=steps, failed=failed,
        end_to_end={"setup_s": setup_s,
                    "train_samples_per_s": samples / window_s},
        context=ctx, memory_peak_bytes=peak, checks=checks,
        info={"window_s": window_s, "steps": steps, "rows_per_step": rows,
              "chunk_steps": chunk, "chunk_s": chunk_s,
              "losses": losses, "ref_losses": ref.losses,
              "end_step": end.step, "end_losses": end.losses,
              "ref_end_losses": ref_end.losses,
              "reference_s": time.perf_counter() - t_ref})


def _traced_phase(r, mix, device, step_s: float):
    """About ``trace_seconds`` of steps under the profiler, taken as the
    window takes them (one ``Run.fit`` call; ``step_s`` is the window's
    mean step), each call of an operation with a work count recorded."""
    from torch.profiler import ProfilerActivity, profile
    ops = OpRecorder()
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    steps = max(1, math.ceil(mix["trace_seconds"] / step_s))
    with ops.recording(), profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            r.fit(steps=steps)
            program.sync(device)
    ops.finish()
    return tracing.summarize(tracing.from_profiler(prof)), ops, steps
