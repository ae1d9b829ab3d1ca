"""Cells: (architecture x input shape x mesh) -> step function,
its arguments and their shardings (the port of ``repro/launch/cells.py``).

A "cell" is one entry of the dry-run/roofline matrix.  Everything here
is allocation-free: parameters, optimizer state and inputs are
``FakeTensor``s of one ``FakeTensorMode`` (``Cell.fake_mode``), built by
the port's own ``init_params`` and ``opt.init`` on the CPU, the
counterpart of ``jax.eval_shape`` and ``ShapeDtypeStruct``.  They live on
the CPU because a fake CUDA tensor would hand a ctypes kernel a pointer
to nothing: under the mode, ``fn`` runs the plain route.

``fn`` takes the positional ``args``; ``in_specs`` holds one spec tree per
argument and ``out_specs`` one per output (``launch/shardings.py``), and
``meta`` is the reference's, formula for formula.  ``REPRO_GNN_IMPL=ring``
(with ``REPRO_RING_STEPS``) and ``REPRO_RECSYS_OPT=rowwise`` select the
reference's ring and row-wise variants, as there.
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Any, Callable

import torch

from repro_torch import configs as config_registry
from repro_torch.core.train_step import value_and_grad
from repro_torch.dist.hints import sharding_hints
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import all_axes, dp_axes, dp_size
from repro_torch.launch.shardings import P
from repro_torch.optim import adafactor, adam

F32, BF16, I32, BOOL = torch.float32, torch.bfloat16, torch.int32, torch.bool


def _sds(shape, dtype) -> torch.Tensor:
    """An argument's stand-in: a tensor with no storage (built under the
    cell's fake mode)."""
    return torch.empty(tuple(shape), dtype=dtype)


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _make_opt(name: str):
    return adam(1e-4) if name == "adam" else adafactor(1e-2)


def _train_update(opt, loss_of):
    """``step(params, opt_state, *data)`` of a loss: value and grad, then
    ``opt.update``, returning (params, opt_state, loss)."""
    def step(params, opt_state, *data):
        loss, grads = value_and_grad(lambda p: loss_of(p, *data), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return step


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable                      # positional-args step function
    args: tuple                       # FakeTensors (and trees of them)
    in_specs: tuple                   # one spec tree per argument
    out_specs: Any
    donate: tuple[int, ...]
    meta: dict
    fake_mode: Any = None             # the FakeTensorMode of ``args``


def list_cells(arch_id: str) -> list[str]:
    return list(config_registry.get(arch_id).SHAPES.keys())


def skipped_cells(arch_id: str) -> dict[str, str]:
    return dict(config_registry.get(arch_id).SKIP)


def build_cell(arch_id: str, shape_name: str, mesh) -> Cell:
    from torch._subclasses.fake_tensor import FakeTensorMode
    arch_id = config_registry.canon(arch_id)
    mod = config_registry.get(arch_id)
    if shape_name in mod.SKIP:
        raise ValueError(f"{arch_id}/{shape_name} skipped: {mod.SKIP[shape_name]}")
    shape = mod.SHAPES[shape_name]
    mode = FakeTensorMode()
    with mode:
        cell = _CELL_KINDS[shape["kind"]](arch_id, mod, shape_name, shape, mesh)
    cell.fake_mode = mode
    return cell


# =========================================================== LM family

def _lm_params(cfg):
    from repro_torch.models.transformer import init_params
    return init_params(cfg, 0, device="cpu")


def _lm_hints(mesh, fn):
    dp = dp_axes(mesh)

    def step(*args):
        with sharding_hints(dp=dp, tp="model"):
            return fn(*args)
    return step


def _lm_train(arch, mod, shape_name, shape, mesh):
    from repro_torch.models import transformer as tfm
    cfg = mod.FULL
    opt = _make_opt(mod.OPTIMIZER)
    b, s = shape["global_batch"], shape["seq_len"]
    dp = dp_axes(mesh)
    # each microbatch must still shard its batch dim over dp
    mb = min(shape.get("microbatches", 1), b // dp_size(mesh))
    params = _lm_params(cfg)
    opt_state = opt.init(params)
    p_spec = shd.lm_param_specs(cfg, mesh)
    o_spec = shd.opt_state_specs(mod.OPTIMIZER, p_spec, params)
    # bf16 grad accumulation for the adafactor giants (340B/1T): the f32
    # accumulator alone is 4 TB on kimi-k2
    gdt = BF16 if mod.OPTIMIZER == "adafactor" else F32
    step = _lm_hints(mesh, partial(tfm.train_step, cfg, opt,
                                   n_microbatches=mb, grad_dtype=gdt))
    args = (params, opt_state, _sds((b, s), I32), _sds((b, s), I32))
    n_par = cfg.param_count()
    n_act = cfg.active_param_count()
    return Cell(arch, shape_name, "train", step, args,
                (p_spec, o_spec, P(dp, None), P(dp, None)),
                (p_spec, o_spec, P()), donate=(0, 1),
                meta=dict(model_flops=6 * n_act * b * s, params=n_par,
                          active_params=n_act, tokens=b * s))


def _lm_prefill(arch, mod, shape_name, shape, mesh):
    from repro_torch.models import transformer as tfm
    cfg = mod.FULL
    b, s = shape["global_batch"], shape["seq_len"]
    dp = dp_axes(mesh)
    p_spec = shd.lm_param_specs(cfg, mesh)
    cache_spec = shd.lm_cache_specs(cfg, mesh, b)
    step = _lm_hints(mesh, partial(tfm.prefill, cfg))
    args = (_lm_params(cfg), _sds((b, s), I32))
    n_act = cfg.active_param_count()
    return Cell(arch, shape_name, "prefill", step, args,
                (p_spec, P(dp, None)), (P(dp, "model"), cache_spec),
                donate=(),
                meta=dict(model_flops=2 * n_act * b * s, params=cfg.param_count(),
                          active_params=n_act, tokens=b * s))


def _lm_decode(arch, mod, shape_name, shape, mesh):
    from repro_torch.models import transformer as tfm
    cfg = mod.FULL
    b, s = shape["global_batch"], shape["seq_len"]
    dp = dp_axes(mesh)
    p_spec = shd.lm_param_specs(cfg, mesh)
    cache_spec = shd.lm_cache_specs(cfg, mesh, b)
    dt = tfm.DTYPES[cfg.dtype]
    kv = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    cache = {"k": _sds(kv, dt), "v": _sds(kv, dt)}
    tok_spec = P(dp, None) if b % dp_size(mesh) == 0 else P(None, None)
    logit_spec = P(dp, "model") if b % dp_size(mesh) == 0 else P(None, "model")
    step = _lm_hints(mesh, partial(tfm.decode_step, cfg))
    args = (_lm_params(cfg), _sds((b, 1), I32), cache, _sds((), I32))
    n_act = cfg.active_param_count()
    return Cell(arch, shape_name, "decode", step, args,
                (p_spec, tok_spec, cache_spec, P()), (logit_spec, cache_spec),
                donate=(2,),
                meta=dict(model_flops=2 * n_act * b, params=cfg.param_count(),
                          active_params=n_act, tokens=b, kv_len=s))


# =========================================================== GNN family

def _gcn_cfg_for_shape(mod, shape):
    from repro_torch.models.gcn import GCNConfig
    base = mod.FULL
    return GCNConfig(name=base.name, n_layers=base.n_layers,
                     d_hidden=base.d_hidden, n_classes=shape["n_classes"],
                     d_feat=shape["d_feat"])


def _gcn_state(cfg, mod, mesh):
    from repro_torch.models.gcn import init_params
    opt = _make_opt(mod.OPTIMIZER)
    params = init_params(cfg, 0, device="cpu")
    p_spec = shd.gcn_param_specs(cfg, mesh)
    return (opt, params, opt.init(params), p_spec,
            shd.opt_state_specs(mod.OPTIMIZER, p_spec, params))


def _gcn_flops(cfg, shape):
    dims = [shape["d_feat"]] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    spmm_flops = sum(2 * shape["n_edges"] * d for d in dims[:-1])
    mm_flops = sum(2 * shape["n_nodes"] * dims[i] * dims[i + 1]
                   for i in range(len(dims) - 1))
    return dims, 3 * (spmm_flops + mm_flops)


def _nll(logits, labels):
    logp = torch.log_softmax(logits, -1)
    return logp.gather(1, labels.long()[:, None])[:, 0]


def _gnn_full(arch, mod, shape_name, shape, mesh):
    # REPRO_GNN_IMPL=ring selects the ring-SpMM variant; REPRO_RING_STEPS=R
    # bounds the ring radius (a locality-partitioned graph)
    if os.environ.get("REPRO_GNN_IMPL") == "ring":
        return _gnn_full_ring(arch, mod, shape_name, shape, mesh)
    from repro_torch.core.graph import Graph
    from repro_torch.models import gcn
    cfg = _gcn_cfg_for_shape(mod, shape)
    nd = mesh.size
    n_pad = _round_up(shape["n_nodes"], nd)
    e_pad = _round_up(shape["n_edges"], nd)
    ax = all_axes(mesh)
    opt, params, opt_state, p_spec, o_spec = _gcn_state(cfg, mod, mesh)

    def loss_of(p, x, src, dst, emask, labels, lmask):
        g = Graph(src, dst, emask, n_pad, shape["n_edges"])
        return gcn.loss_fn(cfg, p, g, x, labels, lmask)

    args = (params, opt_state,
            _sds((n_pad, shape["d_feat"]), F32),
            _sds((e_pad,), I32), _sds((e_pad,), I32), _sds((e_pad,), BOOL),
            _sds((n_pad,), I32), _sds((n_pad,), F32))
    _, flops = _gcn_flops(cfg, shape)
    return Cell(arch, shape_name, "gnn_full", _train_update(opt, loss_of),
                args, (p_spec, o_spec, P(ax, None)) + (P(ax),) * 5,
                (p_spec, o_spec, P()), donate=(0, 1),
                meta=dict(model_flops=flops, n_nodes=shape["n_nodes"],
                          n_edges=shape["n_edges"]))


def _ring_aggregate(x, src_l, dst_l, emask, coeff, n_local: int):
    """Every rank's ring steps at once, as one program over the whole
    mesh: rank r's bucket k holds edges whose sources live on rank
    (r + k) mod nd (relative buckets), local ids on both sides."""
    nd, r = src_l.shape[:2]
    ranks = torch.arange(nd, dtype=torch.int64)[:, None, None]
    owner = (ranks + torch.arange(r, dtype=torch.int64)[None, :, None]) % nd
    src = (owner * n_local + src_l.long()).reshape(-1)
    dst = (ranks * n_local + dst_l.long()).reshape(-1)
    w = torch.where(emask, coeff, 0.0).reshape(-1, 1)
    return torch.zeros_like(x).index_add(0, dst, x.index_select(0, src) * w)


def _gnn_full_ring(arch, mod, shape_name, shape, mesh):
    """Ring-SpMM variant of full-graph GCN training: node-sharded
    features rotate around the flattened device ring; edge buckets are
    relative-banded, REPRO_RING_STEPS (default: the full ring) owners per
    device."""
    cfg = _gcn_cfg_for_shape(mod, shape)
    nd = mesh.size
    ax = all_axes(mesh)
    n_pad = _round_up(shape["n_nodes"], nd)
    n_local = n_pad // nd
    r = int(os.environ.get("REPRO_RING_STEPS", nd))
    e_max = _round_up(int(shape["n_edges"] / (nd * r) * 1.3) + 8, 8)
    opt, params, opt_state, p_spec, o_spec = _gcn_state(cfg, mod, mesh)

    def loss_of(p, x, src_l, dst_l, emask, coeff, labels, lmask):
        h = x
        for li, w in enumerate(p["layers"]):
            h = _ring_aggregate(h, src_l, dst_l, emask, coeff, n_local)
            h = h @ w["w"] + w["b"]
            if li + 1 < cfg.n_layers:
                h = torch.relu(h)
        return -torch.sum(_nll(h, labels) * lmask) / lmask.sum().clamp_min(1.0)

    cube = (nd, r, e_max)
    args = (params, opt_state,
            _sds((n_pad, shape["d_feat"]), F32),
            _sds(cube, I32), _sds(cube, I32), _sds(cube, BOOL), _sds(cube, F32),
            _sds((n_pad,), I32), _sds((n_pad,), F32))
    bspec = P(ax, None, None)
    dims, flops = _gcn_flops(cfg, shape)
    # ring collective bytes (analytic): forward and backward per layer, R
    # steps moving the whole feature matrix once per full rotation fraction
    ring_bytes = 2 * r / nd * sum(n_pad * d * 4 for d in dims[:-1])
    hbm_bytes = 3 * sum(2 * shape["n_edges"] * d * 4 + 3 * n_pad * d * 4
                        for d in dims[:-1])
    return Cell(arch, shape_name, "gnn_full", _train_update(opt, loss_of),
                args, (p_spec, o_spec, P(ax, None)) + (bspec,) * 4
                + (P(ax), P(ax)), (p_spec, o_spec, P()), donate=(0, 1),
                meta=dict(model_flops=flops, n_nodes=shape["n_nodes"],
                          n_edges=shape["n_edges"], ring_steps=r,
                          ring_coll_bytes=ring_bytes,
                          ring_hbm_bytes=hbm_bytes))


def _gnn_sampled(arch, mod, shape_name, shape, mesh):
    from repro_torch.models import gcn
    cfg = _gcn_cfg_for_shape(mod, shape)
    nd = mesh.size
    ax = all_axes(mesh)
    seeds = shape["batch_nodes"]
    f1, f2 = shape["fanouts"]
    # static block sizes (upper bounds, mesh-divisible)
    n1_dst = seeds
    e1 = _round_up(seeds * f1, nd)
    n1_src = _round_up(seeds * (f1 + 1), nd)
    e2 = _round_up(n1_src * f2, nd)
    n2_src = _round_up(n1_src * (f2 + 1), nd)
    opt, params, opt_state, p_spec, o_spec = _gcn_state(cfg, mod, mesh)

    def loss_of(p, x, e2s, e2d, m2, e1s, e1d, m1, labels):
        blocks = [
            dict(edge_src=e2s, edge_dst=e2d, edge_mask=m2, n_dst=n1_src),
            dict(edge_src=e1s, edge_dst=e1d, edge_mask=m1, n_dst=n1_dst),
        ]
        return -torch.mean(_nll(gcn.forward_blocks(cfg, p, blocks, x),
                                labels))

    args = (params, opt_state,
            _sds((n2_src, shape["d_feat"]), F32),
            _sds((e2,), I32), _sds((e2,), I32), _sds((e2,), BOOL),
            _sds((e1,), I32), _sds((e1,), I32), _sds((e1,), BOOL),
            _sds((seeds,), I32))
    flops = 2 * e2 * shape["d_feat"] + 2 * n1_src * shape["d_feat"] * cfg.d_hidden \
        + 2 * e1 * cfg.d_hidden + 2 * seeds * cfg.d_hidden * shape["n_classes"]
    return Cell(arch, shape_name, "gnn_sampled", _train_update(opt, loss_of),
                args, (p_spec, o_spec, P(ax, None)) + (P(ax),) * 7,
                (p_spec, o_spec, P()), donate=(0, 1),
                meta=dict(model_flops=3 * flops, sampled_src=n2_src,
                          sampled_edges=e2))


def _gnn_batched(arch, mod, shape_name, shape, mesh):
    from repro_torch.models import gcn
    cfg = _gcn_cfg_for_shape(mod, shape)
    nd = mesh.size
    ax = all_axes(mesh)
    bsz = shape["batch"]
    n_flat = _round_up(bsz * shape["n_nodes"], nd)
    e_flat = _round_up(bsz * shape["n_edges"], nd)
    opt, params, opt_state, p_spec, o_spec = _gcn_state(cfg, mod, mesh)

    def loss_of(p, x, src, dst, emask, gids, labels):
        logits = gcn.forward_batched(cfg, p, src, dst, emask, x, gids, bsz)
        return -torch.mean(_nll(logits, labels))

    args = (params, opt_state,
            _sds((n_flat, shape["d_feat"]), F32),
            _sds((e_flat,), I32), _sds((e_flat,), I32), _sds((e_flat,), BOOL),
            _sds((n_flat,), I32), _sds((bsz,), I32))
    return Cell(arch, shape_name, "gnn_batched", _train_update(opt, loss_of),
                args, (p_spec, o_spec, P(ax, None)) + (P(ax),) * 4 + (P(),),
                (p_spec, o_spec, P()), donate=(0, 1),
                meta=dict(model_flops=3 * 2 * e_flat * shape["d_feat"]))


# =========================================================== recsys family

def _recsys_params(arch, cfg):
    from repro_torch.models import recsys_models as rm
    init = {"deepfm": rm.deepfm_init, "xdeepfm": rm.xdeepfm_init,
            "dlrm_rm2": rm.dlrm_init, "bert4rec": rm.bert4rec_init}[arch]
    return init(cfg, 0, device="cpu")


def _recsys_forward(arch, cfg):
    from repro_torch.models import recsys_models as rm
    return {"deepfm": partial(rm.deepfm_forward, cfg),
            "xdeepfm": partial(rm.xdeepfm_forward, cfg),
            "dlrm_rm2": partial(rm.dlrm_forward, cfg)}[arch]


def _recsys_embedding_flops(arch, cfg, batch):
    # lookups dominate bytes, interaction+MLP dominates FLOPs
    if arch == "dlrm_rm2":
        f = cfg.n_sparse + 1
        mlp = sum(a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp[:-1],
                                        cfg.bot_mlp))
        top_in = cfg.bot_mlp[-1] + f * (f - 1) // 2
        mlp += sum(a * b for a, b in zip((top_in,) + cfg.top_mlp[:-1],
                                         cfg.top_mlp))
        inter = f * f * cfg.embed_dim
        return 2 * batch * (mlp + inter)
    d_in = cfg.n_sparse * cfg.embed_dim
    mlp = sum(a * b for a, b in zip((d_in,) + cfg.mlp_dims[:-1],
                                    cfg.mlp_dims)) + cfg.mlp_dims[-1]
    extra = 0
    if hasattr(cfg, "cin_layers"):
        h_prev = cfg.n_sparse
        for h in cfg.cin_layers:
            extra += h * h_prev * cfg.n_sparse * cfg.embed_dim
            h_prev = h
    else:
        extra = cfg.n_sparse * cfg.embed_dim  # FM
    return 2 * batch * (mlp + extra)


def _recsys_io(arch, cfg, batch, mesh, with_labels):
    """(args, specs, batch spec) for the dense/ids(/labels) inputs."""
    dpall = all_axes(mesh)
    nd = mesh.size
    bspec = P(dpall) if batch % nd == 0 else P()
    bspec2 = P(dpall, None) if batch % nd == 0 else P(None, None)
    args, specs = [], []
    if arch == "dlrm_rm2":
        args.append(_sds((batch, cfg.n_dense), F32))
        specs.append(bspec2)
    args.append(_sds((batch, cfg.n_sparse), I32))
    specs.append(bspec2)
    if with_labels:
        args.append(_sds((batch,), F32))
        specs.append(bspec)
    return args, specs, bspec


def _recsys_train_rowwise(arch, mod, shape_name, shape, mesh):
    """dlrm-rm2 variant: lazy row-wise AdaGrad on the embedding tables
    (REPRO_RECSYS_OPT=rowwise).  Dense towers keep Adam; tables touch only
    the B*F gathered rows per step instead of the full [F, V, D] tensor
    (+m,v) that dense Adam streams."""
    from repro_torch.models.recsys_models import (bce_loss,
                                                  dlrm_forward_from_emb,
                                                  lookup_fields,
                                                  rowwise_adagrad_update)
    cfg = mod.FULL
    opt = _make_opt(mod.OPTIMIZER)
    batch = shape["batch"]
    dpall = all_axes(mesh)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)
    dense_keys = ("bot", "top")
    dense = {k: params[k] for k in dense_keys}
    opt_state = {"acc": _sds((cfg.n_sparse, cfg.vocab), F32),
                 "mlp": opt.init(dense)}
    o_spec = {"acc": P(None, dpall),
              "mlp": shd.opt_state_specs(mod.OPTIMIZER,
                                         {k: p_spec[k] for k in dense_keys},
                                         dense)}
    data_args, data_specs, _ = _recsys_io(arch, cfg, batch, mesh,
                                          with_labels=True)

    def step(params, opt_state, dense_x, ids, labels):
        emb = lookup_fields(params["tables"], ids)
        mlps = {k: params[k] for k in dense_keys}

        def loss_of(t):
            p2 = dict(params, **t["mlps"])
            return bce_loss(dlrm_forward_from_emb(cfg, p2, dense_x, t["emb"]),
                            labels)

        loss, g = value_and_grad(loss_of, {"emb": emb, "mlps": mlps})
        tables, acc = rowwise_adagrad_update(params["tables"],
                                             opt_state["acc"], ids, g["emb"])
        new_mlps, mlp_state = opt.update(g["mlps"], opt_state["mlp"], mlps)
        new_params = dict(params, tables=tables, **new_mlps)
        return new_params, {"acc": acc, "mlp": mlp_state}, loss

    d = cfg.embed_dim
    touched = batch * cfg.n_sparse
    analytic_hbm = (6 * touched * d * 4          # gather + scatter + scale rows
                    + 4 * touched * 4            # accumulator rows
                    + 3 * 8 * batch * 1024 * 4)  # mlp fwd/bwd approx
    analytic_coll = 6 * touched * d * 4          # a2a-ish lookup + grad return
    return Cell(arch, shape_name, "recsys_train", step,
                (params, opt_state, *data_args),
                (p_spec, o_spec, *data_specs), (p_spec, o_spec, P()),
                donate=(0, 1),
                meta=dict(model_flops=3 * _recsys_embedding_flops(arch, cfg, batch),
                          batch=batch, analytic_hbm=float(analytic_hbm),
                          analytic_coll=float(analytic_coll),
                          variant="rowwise_adagrad"))


def _recsys_train(arch, mod, shape_name, shape, mesh):
    if os.environ.get("REPRO_RECSYS_OPT") == "rowwise" and arch == "dlrm_rm2":
        return _recsys_train_rowwise(arch, mod, shape_name, shape, mesh)
    from repro_torch.models.recsys_models import bce_loss
    cfg = mod.FULL
    opt = _make_opt(mod.OPTIMIZER)
    batch = shape["batch"]
    fwd = _recsys_forward(arch, cfg)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)
    o_spec = shd.opt_state_specs(mod.OPTIMIZER, p_spec, params)
    data_args, data_specs, _ = _recsys_io(arch, cfg, batch, mesh,
                                          with_labels=True)

    def loss_of(p, *data):
        *feats, labels = data
        return bce_loss(fwd(p, *feats), labels)

    d = cfg.embed_dim
    table_bytes = cfg.n_sparse * cfg.vocab * d * 4
    touched = batch * cfg.n_sparse
    # dense Adam streams the whole table + m + v (read+write each)
    analytic_hbm = 6 * table_bytes + 4 * touched * d * 4
    analytic_coll = 6 * touched * d * 4
    return Cell(arch, shape_name, "recsys_train", _train_update(opt, loss_of),
                (params, opt.init(params), *data_args),
                (p_spec, o_spec, *data_specs), (p_spec, o_spec, P()),
                donate=(0, 1),
                meta=dict(model_flops=3 * _recsys_embedding_flops(arch, cfg, batch),
                          batch=batch, analytic_hbm=float(analytic_hbm),
                          analytic_coll=float(analytic_coll),
                          variant="dense_adam"))


def _recsys_serve(arch, mod, shape_name, shape, mesh):
    cfg = mod.FULL
    batch = shape["batch"]
    fwd = _recsys_forward(arch, cfg)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)
    data_args, data_specs, bspec = _recsys_io(arch, cfg, batch, mesh,
                                              with_labels=False)

    def step(params, *feats):
        with torch.no_grad():
            return fwd(params, *feats)

    return Cell(arch, shape_name, "recsys_serve", step,
                (params, *data_args), (p_spec, *data_specs), bspec,
                donate=(),
                meta=dict(model_flops=_recsys_embedding_flops(arch, cfg, batch),
                          batch=batch))


def _recsys_retrieval(arch, mod, shape_name, shape, mesh):
    from repro_torch.models.recsys_models import dlrm_retrieve
    cfg = mod.FULL
    c = shape["n_candidates"]
    dpall = all_axes(mesh)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)

    if arch == "dlrm_rm2":
        def step(params, dense, ids, cand):
            return dlrm_retrieve(cfg, params, dense, ids, cand)
        args = (params, _sds((1, cfg.n_dense), F32),
                _sds((1, cfg.n_sparse), I32), _sds((c,), I32))
        specs = (p_spec, P(None, None), P(None, None), P(dpall))
    else:
        fwd = _recsys_forward(arch, cfg)

        def step(params, ids, cand):
            # broadcast user fields, swap field 0 with the candidates
            with torch.no_grad():
                ids_b = ids.expand(c, cfg.n_sparse).clone()
                ids_b[:, 0] = cand
                return fwd(params, ids_b)
        args = (params, _sds((1, cfg.n_sparse), I32), _sds((c,), I32))
        specs = (p_spec, P(None, None), P(dpall))
    return Cell(arch, shape_name, "recsys_retrieval", step, args, specs,
                P(dpall), donate=(),
                meta=dict(model_flops=_recsys_embedding_flops(arch, cfg, c),
                          candidates=c))


# =========================================================== bert4rec (seq)

def _seq_encoder_flops(cfg, b):
    s, d = cfg.seq_len, cfg.embed_dim
    return cfg.n_blocks * (4 * d * d + 2 * d * cfg.d_ff) * s * b * 2 \
        + cfg.n_blocks * 2 * b * s * s * d * 2


def _seq_train(arch, mod, shape_name, shape, mesh):
    from repro_torch.models.recsys_models import bert4rec_sampled_loss
    cfg = mod.FULL
    opt = _make_opt(mod.OPTIMIZER)
    b = shape["batch"]
    m, n_neg = mod.N_MASKED, mod.N_NEGATIVES
    dpall = all_axes(mesh)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)
    o_spec = shd.opt_state_specs(mod.OPTIMIZER, p_spec, params)
    loss_of = partial(bert4rec_sampled_loss, cfg)
    s = cfg.seq_len
    args = (params, opt.init(params), _sds((b, s), I32), _sds((b, s), BOOL),
            _sds((b, m), I32), _sds((b, m), I32), _sds((b, m, n_neg), I32))
    specs = (p_spec, o_spec) + (P(dpall, None),) * 4 + (P(dpall, None, None),)
    d = cfg.embed_dim
    enc = _seq_encoder_flops(cfg, b)
    return Cell(arch, shape_name, "seq_train", _train_update(opt, loss_of),
                args, specs, (p_spec, o_spec, P()), donate=(0, 1),
                meta=dict(model_flops=3 * (enc + 2 * b * m * (n_neg + 1) * d),
                          batch=b))


def _seq_serve(arch, mod, shape_name, shape, mesh):
    from repro_torch.models.recsys_models import bert4rec_serve
    cfg = mod.FULL
    b = shape["batch"]
    slate = 1024
    dpall = all_axes(mesh)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)
    bspec = dpall if b % mesh.size == 0 else None

    def step(params, seq, smask, slate_ids):
        with torch.no_grad():
            return bert4rec_serve(cfg, params, seq, smask, slate_ids)

    s = cfg.seq_len
    args = (params, _sds((b, s), I32), _sds((b, s), BOOL),
            _sds((b, slate), I32))
    return Cell(arch, shape_name, "seq_serve", step, args,
                (p_spec,) + (P(bspec, None),) * 3,
                (P(bspec, None), P(bspec, None)), donate=(),
                meta=dict(model_flops=_seq_encoder_flops(cfg, b), batch=b))


def _seq_retrieval(arch, mod, shape_name, shape, mesh):
    from repro_torch.models.recsys_models import bert4rec_retrieve
    cfg = mod.FULL
    b, c = shape["batch"], shape["n_candidates"]
    dpall = all_axes(mesh)
    params = _recsys_params(arch, cfg)
    p_spec = shd.recsys_param_specs(arch, params, mesh)

    def step(params, seq, smask, cand):
        with torch.no_grad():
            return bert4rec_retrieve(cfg, params, seq, smask, cand)

    s = cfg.seq_len
    args = (params, _sds((b, s), I32), _sds((b, s), BOOL), _sds((c,), I32))
    return Cell(arch, shape_name, "seq_retrieval", step, args,
                (p_spec, P(None, None), P(None, None), P(dpall)),
                P(None, dpall), donate=(),
                meta=dict(model_flops=2 * b * c * cfg.embed_dim, candidates=c))


# =========================================================== NGCF/LightGCN

def _gnnrecsys_train(arch, mod, shape_name, shape, mesh):
    from repro_torch.core import bpr, lightgcn, ngcf
    from repro_torch.core.graph import BipartiteGraph
    cfg = mod.FULL
    opt = _make_opt(mod.OPTIMIZER)
    dpall = all_axes(mesh)
    e_pad = _round_up(cfg.n_edges, mesh.size)
    is_ngcf = arch == "ngcf"
    if is_ngcf:
        params = ngcf.init_params(0, cfg.n_users, cfg.n_items, cfg.embed_dim,
                                  cfg.n_layers, device="cpu")
    else:
        params = lightgcn.init_params(0, cfg.n_users, cfg.n_items,
                                      cfg.embed_dim, device="cpu")
    p_spec = shd.gnnrecsys_param_specs(cfg, mesh,
                                       "ngcf" if is_ngcf else "lightgcn")
    o_spec = shd.opt_state_specs(mod.OPTIMIZER, p_spec, params)

    def loss_of(p, user, item, emask, bu, bi, bn):
        g = BipartiteGraph(user, item, emask, cfg.n_users, cfg.n_items,
                           cfg.n_edges)
        if is_ngcf:
            ue, ie = ngcf.forward(p, g, opt_level=3)
        else:
            ue, ie = lightgcn.forward(p, g, n_layers=cfg.n_layers)
        return bpr.bpr_loss(ue, ie, bu, bi, bn)

    bb = cfg.bpr_batch
    args = (params, opt.init(params),
            _sds((e_pad,), I32), _sds((e_pad,), I32), _sds((e_pad,), BOOL),
            _sds((bb,), I32), _sds((bb,), I32), _sds((bb,), I32))
    d = cfg.embed_dim
    # per layer: SDDMM mul (E*D) + 2 SpMM (E*D each); NGCF adds O(V*D^2) matmuls
    per_layer = 3 * 2 * cfg.n_edges * d
    if is_ngcf:
        per_layer += 2 * (cfg.n_users + cfg.n_items) * d * d * 2
    meta = dict(model_flops=3 * cfg.n_layers * per_layer,
                n_edges=cfg.n_edges, bpr_batch=bb)
    if is_ngcf:
        # NGCF byte model (paper §2.1): the dominant HBM term is the
        # per-layer [E, D] Hadamard message stream — written by the
        # SDDMM-mul, read by both SpMMs, and saved/re-read for the
        # backward (~4 touches a layer, both directions).  The fused
        # hadamard_spmm route forms the product on chip and recomputes it
        # in the backward, so that term vanishes; the node-level
        # gather/scatter and optimizer traffic stand.
        row = d * 4
        v = cfg.n_users + cfg.n_items
        msg_bytes = cfg.n_layers * 2 * 4 * cfg.n_edges * row
        node_bytes = cfg.n_layers * 3 * 2 * (2 * cfg.n_edges + 2 * v) * row
        opt_bytes = 6 * (cfg.n_layers + 1) * v * row   # adam: p+m+v r/w
        coll_bytes = 2 * (cfg.n_layers + 1) * v * row  # grad all-reduce
        meta.update(analytic_hbm=float(msg_bytes + node_bytes + opt_bytes),
                    analytic_coll=float(coll_bytes),
                    hadamard_msg_hbm_bytes=float(msg_bytes))
    return Cell(arch, shape_name, "gnnrecsys_train",
                _train_update(opt, loss_of), args,
                (p_spec, o_spec) + (P(dpall),) * 6, (p_spec, o_spec, P()),
                donate=(0, 1), meta=meta)


_CELL_KINDS = {
    "train": _lm_train,
    "prefill": _lm_prefill,
    "decode": _lm_decode,
    "gnn_full": _gnn_full,
    "gnn_sampled": _gnn_sampled,
    "gnn_batched": _gnn_batched,
    "recsys_train": _recsys_train,
    "recsys_serve": _recsys_serve,
    "recsys_retrieval": _recsys_retrieval,
    "seq_train": _seq_train,
    "seq_serve": _seq_serve,
    "seq_retrieval": _seq_retrieval,
    "gnnrecsys_train": _gnnrecsys_train,
}


def input_specs(arch_id: str, shape_name: str, mesh):
    """Stand-ins (FakeTensors, no storage) for every model input of the
    given cell."""
    return build_cell(arch_id, shape_name, mesh).args
