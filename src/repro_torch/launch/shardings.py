"""Parameter, optimizer-state and data sharding rules per model family
(the port of ``repro/launch/shardings.py``): the same rules, over the
port's parameter trees.

A spec is a tuple with one entry per dimension of its tensor: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over their product), as a JAX ``PartitionSpec``'s entries.

LM transformers: FSDP x TP — every weight matrix shards its d_model-like
dim over the data-parallel axes (ZeRO-3 storage) and its heads/ffn dim
over 'model' (tensor parallelism).  MoE experts shard over 'model'
(expert parallelism) when n_experts divides the axis, else TP-in-expert
(mixtral: 8 experts < 16).

Optimizer state: adam m/v inherit the param spec; adafactor's factored
moments drop the corresponding dim from the spec.

``per_device_bytes`` prices a spec on a mesh with no devices behind it:
each sharded dimension is ceil-divided by its axes' product, as GSPMD
pads.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import all_axes, dp_axes
from repro_torch.optim.optimizers import tree_map, tree_map_with_path


def P(*entries) -> tuple:
    """A spec from its entries, as ``PartitionSpec(*entries)``."""
    return tuple(entries)


def axes_size(entry, mesh) -> int:
    """The number of shards one spec entry splits its dimension into."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in names)


def per_device_bytes(shape, dtype: torch.dtype, spec, mesh) -> int:
    """Bytes one device holds of a tensor of ``shape`` and ``dtype`` laid
    out by ``spec`` on ``mesh`` (a spec shorter than the shape replicates
    the trailing dimensions)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for dim, entry in zip(shape, spec):
        n *= -(-int(dim) // axes_size(entry, mesh))
    return n * torch.empty((), dtype=dtype).element_size()


def tree_bytes_per_device(tree, spec_tree, mesh) -> int:
    """``per_device_bytes`` summed over a tree of tensors and its specs."""
    out = []
    tree_map(lambda t, s: out.append(per_device_bytes(t.shape, t.dtype, s,
                                                      mesh)),
             tree, spec_tree)
    return sum(out)


# ----------------------------------------------------------------- LM

def lm_param_specs(cfg, mesh):
    dp = dp_axes(mesh)
    tp = "model"
    layers = {
        "attn_norm": P(None, None),
        "ffn_norm": P(None, None),
        "wq": P(None, dp, tp),
        "wk": P(None, dp, tp),
        "wv": P(None, dp, tp),
        "wo": P(None, tp, dp),
    }
    if cfg.is_moe:
        layers["router"] = P(None, dp, None)
        if cfg.n_experts % mesh.shape[tp] == 0:
            # expert parallelism
            layers["w_up"] = P(None, tp, dp, None)
            layers["w_down"] = P(None, tp, None, dp)
            if cfg.activation == "swiglu":
                layers["w_gate"] = P(None, tp, dp, None)
        else:
            # TP within each expert
            layers["w_up"] = P(None, None, dp, tp)
            layers["w_down"] = P(None, None, tp, dp)
            if cfg.activation == "swiglu":
                layers["w_gate"] = P(None, None, dp, tp)
        if cfg.shared_experts:
            layers["ws_up"] = P(None, dp, tp)
            layers["ws_down"] = P(None, tp, dp)
    else:
        layers["w_up"] = P(None, dp, tp)
        layers["w_down"] = P(None, tp, dp)
        if cfg.activation == "swiglu":
            layers["w_gate"] = P(None, dp, tp)
    return {
        # vocab-parallel only (no FSDP dim): both vocab matrices' forward
        # and backward are clean tp-sharded matmuls plus a dp all-reduce
        "embed": P(tp, None),
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(None, tp),
    }


def lm_cache_specs(cfg, mesh, batch: int):
    """KV cache [L, B, Hkv, S, dh]: batch over dp when divisible, else
    sequence over every axis (long-context single-stream)."""
    dp = dp_axes(mesh)
    dp_sz = math.prod(mesh.shape[a] for a in dp)
    if batch % dp_sz == 0 and batch >= dp_sz:
        spec = P(None, dp, None, "model", None)
    else:
        spec = P(None, None, None, all_axes(mesh), None)
    return {"k": spec, "v": spec}


# ----------------------------------------------------------------- opt state

def adam_state_specs(param_specs):
    return {"m": param_specs, "v": param_specs, "t": P()}


def adafactor_state_specs(param_specs, params):
    def leaf(spec, p):
        n = len(p.shape)
        if n >= 2:
            return {"vr": P(*spec[:n - 1]),
                    "vc": P(*(tuple(spec[:n - 2]) + (spec[n - 1],)))}
        return {"v": spec}

    return {"s": _map_specs(leaf, param_specs, params), "t": P()}


def opt_state_specs(optimizer_name: str, param_specs, params):
    if optimizer_name == "adam":
        return adam_state_specs(param_specs)
    if optimizer_name == "adafactor":
        return adafactor_state_specs(param_specs, params)
    if optimizer_name == "sgd":
        return ()
    raise ValueError(optimizer_name)


def _map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree whose leaves are tuples."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, tree[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, s, t) for s, t in zip(specs, tree)]
    return fn(specs, tree)


# ----------------------------------------------------------------- others

def gcn_param_specs(cfg, mesh):
    # GCN weights are tiny (1433x16, 16x7): replicate
    return {"layers": [{"w": P(None, None), "b": P(None)}
                       for _ in range(cfg.n_layers)]}


def recsys_param_specs(model_name: str, params, mesh):
    """Tables row-sharded over the whole mesh (capacity-tier residency);
    dense towers replicated."""
    ax = all_axes(mesh)

    def leaf_spec(name, p):
        if "tables" in name:
            return P(None, ax, None)
        if "linear" in name:
            return P(None, ax)
        if "item_embed" in name:
            return P(ax, None)
        if "out_bias" in name:
            return P(ax)
        return P(*([None] * len(p.shape)))

    return tree_map_with_path(leaf_spec, params)


def gnnrecsys_param_specs(cfg, mesh, model: str):
    ax = all_axes(mesh)
    specs = {"user_embed": P(ax, None), "item_embed": P(ax, None)}
    if model == "ngcf":
        specs["w1"] = [P(None, None)] * cfg.n_layers
        specs["w2"] = [P(None, None)] * cfg.n_layers
    return specs
