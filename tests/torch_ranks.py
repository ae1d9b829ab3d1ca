"""Runs of the port with several ranks, for the sharded tests (not a test
file): ``run_ranks`` spawns P processes that open one gloo process group
over a ``FileStore`` under the test's ``tmp_path`` (no port is opened),
each runs one job below with one torch thread, and their results come back
in rank order.  Each spawn has its own deadline, so a hung collective fails
the test instead of eating the suite's clock.

The jobs import torch, numpy and the port only (never JAX): a test holds
their results against the reference in its own process and passes them
what they need (initial params through ``.npz`` files).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import traceback
import uuid

import numpy as np
import torch

DEADLINE_S = 120


def run_ranks(tmp_path, world: int, job: str, **args) -> list:
    """Run ``job(rank, world, **args)`` in ``world`` spawned gloo ranks;
    returns each rank's result.  Raises AssertionError with the failing
    ranks' tracebacks, or when the spawn passes its deadline."""
    run_dir = pathlib.Path(tmp_path) / f"{job}-{world}-{uuid.uuid4().hex}"
    run_dir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(job, rank, world, str(run_dir), args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=DEADLINE_S)
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errors = [(run_dir / f"error_{r}.txt").read_text()
              for r in range(world) if (run_dir / f"error_{r}.txt").exists()]
    assert not errors, f"{job}: rank errors:\n" + "\n".join(errors)
    assert not hung, f"{job}: ranks {hung} still running after " \
                     f"{DEADLINE_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{job}: exit codes {codes}"
    return [torch.load(run_dir / f"result_{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(job, rank, world, run_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    run_dir = pathlib.Path(run_dir)
    try:
        store = dist.FileStore(str(run_dir / "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=90))
        torch.save(JOBS[job](rank, world, **args),
                   run_dir / f"result_{rank}.pt")
        # every rank is past its last collective before any exits; the
        # ranks then leave without tearing the group down (gloo's teardown
        # can abort while a peer's sockets close)
        dist.barrier()
    except BaseException:
        (run_dir / f"error_{rank}.txt").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)
    os._exit(0)


# ---------------------------------------------------------------- helpers
def _numpy(tree):
    from repro_torch.optim.optimizers import tree_paths
    return {p: t.detach().cpu().numpy() for p, t in tree_paths(tree)}


def _params_from_npz(pipe, path):
    """The whole params saved at ``path`` (keyed by their tree paths), in
    the pipeline's params structure."""
    from repro_torch.optim.optimizers import tree_map_with_path
    arrays = np.load(path)
    return tree_map_with_path(
        lambda p, _: torch.from_numpy(arrays[p].copy()),
        pipe._full["params"])


def _start_from(run, params):
    """The run restarted from whole ``params`` with fresh optimizer (and
    compressor) state, as the reference's own init has."""
    pipe = run.pipeline
    state = {"params": params, "opt": pipe.opt.init(params)}
    if pipe.compressor is not None:
        state["comp"] = pipe.compressor.init_state(params, pipe.cfg.seed)
    run.state = pipe.restore_state(state)


def _build(overrides, params_npz=None):
    from repro_torch.api import Experiment
    run = Experiment.from_preset("lightgcn-smoke", overrides).build(
        device="cpu")
    if params_npz is not None:
        _start_from(run, _params_from_npz(run.pipeline, params_npz))
    return run


def _storage_bad(pipe, state) -> list:
    """The paths of leaves stored otherwise than a rank should: every
    row-sharded leaf holds 1/P of its whole leaf's rows and owns no more
    storage than that; every other leaf is whole.  Empty when all are."""
    from repro_torch.optim.optimizers import tree_paths
    p = pipe.shard.n_shards
    bad = []
    for (path, t), (_, ex) in zip(tree_paths(state), tree_paths(pipe._full)):
        if pipe._sharded(ex):
            own = t.numel() * t.element_size()
            ok = t.shape[0] * p == ex.shape[0] \
                and tuple(t.shape[1:]) == tuple(ex.shape[1:]) \
                and t.untyped_storage().nbytes() == own
        else:
            ok = tuple(t.shape) == tuple(ex.shape)
        if not ok:
            bad.append(path)
    return bad


# ---------------------------------------------------------------- jobs
def ring_ops(rank, world, user, item, n_users, n_items, x_user, x_item,
             c_user, c_item, cases):
    """Each case (ring_steps, int8): the sym propagation forward and the
    gradients of a nonlinear and a linear loss, ``agg_u2i``/``agg_i2u``
    forward, and the sym ring's rotation and payload counts of one call.
    Rank 0 carries each loss (the others weigh theirs by 0), and each
    rank's gradient of the replicated inputs is its part of the whole,
    so they are all-reduced as the engine all-reduces a replicated leaf's.
    """
    from repro_torch.dist.collectives import all_reduce_
    from repro_torch.pipeline.shard import ShardPlan
    from repro_torch.pipeline.sparse import BipartiteCSR
    out = []
    for steps, quant in cases:
        shard = ShardPlan((world,), ("data",), spmm="ring", ring_steps=steps,
                          ring_quant=quant)
        g = BipartiteCSR(user, item, n_users, n_items, device="cpu",
                         shard=shard)
        xu = torch.from_numpy(x_user).requires_grad_(True)
        xi = torch.from_numpy(x_item).requires_grad_(True)
        own = 1.0 if rank == 0 else 0.0
        hu, hi = g.sym_propagate(xu, xi)
        sym = g._ring.ring("sym")
        counts = (sym.rotations, sym.payload_bytes)
        loss = ((hu ** 2).sum() + (hi ** 3).sum()) * own
        grads = [all_reduce_(t, g._ring.group)
                 for t in torch.autograd.grad(loss, (xu, xi))]
        hu2, hi2 = g.sym_propagate(xu, xi)
        lin = ((hu2 * torch.from_numpy(c_user)).sum()
               + (hi2 * torch.from_numpy(c_item)).sum()) * own
        lin_grads = [all_reduce_(t, g._ring.group)
                     for t in torch.autograd.grad(lin, (xu, xi))]
        with torch.no_grad():
            u2i = g.agg_u2i(xu)
            i2u = g.agg_i2u(xi)
        out.append({"h": (hu.detach().numpy(), hi.detach().numpy()),
                    "grads": [t.numpy() for t in grads],
                    "lin_grads": [t.numpy() for t in lin_grads],
                    "u2i": u2i.numpy(), "i2u": i2u.numpy(),
                    "counts": counts,
                    "n_local": g._ring.part.n_local,
                    "fused_hadamard": g.fused_hadamard})
    return out


def sharded_fit(rank, world, overrides, params_npz, steps, evaluate=False):
    """A sharded ``Run.fit`` from the given init: losses, plan numbers,
    whether every leaf is stored at 1/P between steps, the whole final
    params, and (with ``evaluate``) evaluate() and the sharded top-K
    against the unsharded sweep on the same embeddings."""
    from repro_torch.eval import streaming_topk
    run = _build(overrides, params_npz)
    pipe = run.pipeline
    rep = run.fit(steps=steps)
    out = {"losses": rep.losses, "shards": pipe.plan.shards,
           "global_microbatch": pipe.plan.global_microbatch,
           "microbatch": pipe.plan.microbatch,
           "lr0": pipe.lr_for_epoch(0), "describe": run.describe(),
           "storage_bad": _storage_bad(pipe, run.state),
           "compressor": pipe.compressor.describe()
           if pipe.compressor is not None else None,
           "params": _numpy(pipe.unshard_state(run.state)["params"])}
    if evaluate:
        ue, ie = run.embeddings()
        s0, i0 = streaming_topk(ue, ie, 10, user_batch=6, device="cpu")
        s1, i1 = streaming_topk(ue, ie, 10, user_batch=6, device="cpu",
                                shard=pipe.shard)
        out["topk"] = (s0, i0, s1, i1)
        out["metrics"] = run.evaluate()
    return out


def sharded_runs(rank, world, runs, params_npz, steps):
    """Several sharded runs from one init: {name: losses}; for names
    ending in '_state' also the whole final state."""
    out = {}
    for name, overrides in runs.items():
        run = _build(overrides, params_npz)
        out[name] = run.fit(steps=steps).losses
        out[name + "_state"] = _numpy(run.pipeline.unshard_state(run.state))
        out[name + "_offloaded"] = run.pipeline.n_offloaded
        out[name + "_storage_bad"] = _storage_bad(run.pipeline, run.state)
    return out


def save_sharded(rank, world, overrides, params_npz, steps, ckpt_dir):
    """Fit with checkpoints under ``ckpt_dir``; the whole final state."""
    run = _build({**overrides, "loop.ckpt_dir": ckpt_dir,
                  "loop.ckpt_every": 1}, params_npz)
    run.fit(steps=steps)
    return _numpy(run.pipeline.unshard_state(run.state))


def restore_sharded(rank, world, overrides, ckpt_dir):
    """Resume from ``ckpt_dir``: this rank's part, and the whole state."""
    run = _build(overrides)
    run.resume(ckpt_dir)
    return {"local": _numpy(run.state), "step": run.step_count,
            "storage_bad": _storage_bad(run.pipeline, run.state),
            "whole": _numpy(run.pipeline.unshard_state(run.state))}


def collectives(rank, world, grads, seed, k):
    """The compression collectives on this rank's ``grads[rank]``: the int8
    sum (twice from one seed: without and with the residual) and the top-k
    all-gather sum."""
    import torch.distributed as dist
    from repro_torch.optim.compression import (compressed_psum_int8,
                                               psum_int8_with_residual,
                                               topk_allgather_sum,
                                               topk_sparsify)
    g = torch.from_numpy(grads[rank])
    group = dist.group.WORLD
    total = compressed_psum_int8(
        g, torch.Generator().manual_seed(seed + rank), group)
    again, resid = psum_int8_with_residual(
        g, torch.Generator().manual_seed(seed + rank), group)
    vals, idx, _ = topk_sparsify(g, k)
    return {"total": total.numpy(), "again": again.numpy(),
            "resid": resid.numpy(),
            "topk": topk_allgather_sum(vals, idx, g.shape, group).numpy()}


JOBS = {f.__name__: f for f in (ring_ops, sharded_fit, sharded_runs,
                                save_sharded, restore_sharded, collectives)}
