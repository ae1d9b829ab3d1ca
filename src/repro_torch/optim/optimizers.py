"""Functional optimizers (init/update pairs): the port of
``repro/optim/optimizers.py::sgd``, ``adam`` and ``adafactor``, with its
``WarmupLinearLR`` schedule and ``global_norm_clip``.

Parameters are nested dicts and lists of tensors (NGCF's ``w1``/``w2``
lists, GCN's ``layers`` list of dicts, the transformer's stacked
``layers``).  The updates follow the reference's formulas exactly rather
than ``torch.optim``: Adam's bias corrections ``1 - b ** t`` are float32
computations on a float32 ``t``, as in JAX, and the learning rate may
come as a float32 scalar tensor (the engine passes the epoch's LR so).
Updates return new tensors and leave their inputs as they were, as the
reference's pure functions do.

Dtypes follow JAX's promotion, not torch's: JAX promotes a bfloat16 array
combined with a float32 array to float32 even when the float32 array is
0-d (Adam's ``bc1``, a tensor learning rate, the clip scale), where torch
lets a 0-d tensor promote like a Python scalar and keeps bfloat16.  So
bfloat16 params and gradients come out of ``adam`` as float32 params
beside bfloat16 moments, as the reference's do; ``_up`` makes each such
promotion explicit.  Python numbers stay weak in both.  Float32 updates
are untouched by it.

Each leaf's update is elementwise and runs in pieces of ``CHUNK``
elements (``_elementwise``), so a FULL-size leaf's temporaries stay
bounded: the values are the same, piece by piece.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts/lists/tuples that
    share ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted,
    sequences in order), each path as ``jax.tree_util.keystr`` writes it:
    ``['user_embed']``, ``['m']['item_embed']``, ``['w1'][0]``.  ``None``
    and empty containers hold no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], f"{path}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_paths(v, f"{path}[{i}]"))
        return out
    return [(path, tree)]


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves, ``tree``'s structure kept; the
    paths are ``tree_paths``'."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params[, lr=...]) -> (new_params, new_state)
    update: Callable[..., tuple[Any, Any]]


# elements per piece of an elementwise leaf update (``_elementwise``): a
# float32 temporary of one piece is 256 MiB
CHUNK = 1 << 26


def _up(x: torch.Tensor, *others) -> torch.Tensor:
    """``x`` cast to the dtype JAX gives an operation between ``x`` and the
    tensors among ``others`` (Python numbers are weak and do not count):
    a 0-d float32 tensor promotes bfloat16 to float32, as a JAX array does
    (torch would keep bfloat16).  No copy where the dtype stays."""
    dt = x.dtype
    for o in others:
        if isinstance(o, torch.Tensor):
            dt = torch.promote_types(dt, o.dtype)
    return x.to(dt)


def _elementwise(fn, *leaves):
    """``fn(*leaves)`` for an elementwise ``fn`` of same-shaped tensors
    returning a tuple of them, run over pieces of CHUNK elements into
    tensors allocated once, so its temporaries hold one piece each."""
    n = leaves[0].numel()
    if n <= CHUNK:
        return fn(*leaves)
    flat = [x.reshape(-1) for x in leaves]
    outs = None
    for i in range(0, n, CHUNK):
        part = fn(*(f[i:i + CHUNK] for f in flat))
        if outs is None:
            outs = [torch.empty(n, dtype=r.dtype, device=r.device)
                    for r in part]
        for o, r in zip(outs, part):
            o[i:i + CHUNK] = r
    return tuple(o.view(leaves[0].shape) for o in outs)


def _unzip(tree, outs: list, n: int) -> tuple:
    """``n`` trees of ``tree``'s structure from ``outs``, one n-tuple per
    leaf in ``tree_leaves`` order."""
    def rebuild(j):
        it = iter([o[j] for o in outs])
        return tree_map(lambda _: next(it), tree)
    return tuple(rebuild(j) for j in range(n))


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def step(p, d, lr):
        u = lr * _up(d, lr)
        return _up(p, u) - u

    def update(grads, state, params, lr=lr):
        if momentum == 0.0:
            return tree_map(lambda p, g: step(p, g, lr), params, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        new_p = tree_map(lambda p, m: step(p, m, lr), params, new_m)
        return new_p, new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr=None):
        t = state["t"] + 1
        step_lr = lr if lr is not None else base_lr
        tf = t.to(torch.float32)
        # float32 bias corrections, as jnp computes them
        bc1 = 1 - torch.full_like(tf, b1) ** tf
        bc2 = 1 - torch.full_like(tf, b2) ** tf

        def leaf(p, m, v, g):
            m_ = b1 * m + (1 - b1) * g
            v_ = b2 * v + (1 - b2) * g * g
            u = step_lr * (_up(m_, bc1) / bc1) \
                / (torch.sqrt(_up(v_, bc2) / bc2) + eps)
            return _up(p, u) - u, m_, v_

        outs = [_elementwise(leaf, *x) for x in zip(
            tree_leaves(params), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(grads))]
        new_p, m, v = _unzip(params, outs, 3)
        return new_p, {"m": m, "v": v, "t": t}

    base_lr = lr
    return Optimizer(init, update)


def _fdiv(x: torch.Tensor, d) -> torch.Tensor:
    """x / d as a true division by a float32 tensor: torch would multiply
    by the reciprocal of a Python scalar.  The tensor is filled on x's
    device (``torch.tensor`` would copy it from the host and wait)."""
    return x / torch.full((), float(d), dtype=torch.float32,
                          device=x.device)


def _pieces(n: int, r: int, c: int) -> list:
    """(matrices, rows) slices of an [n, r, c] leaf, each piece at most
    CHUNK elements where a row fits: whole matrices together while one
    fits, else whole rows of one matrix."""
    if r * c <= CHUNK:
        step = max(1, CHUNK // max(r * c, 1))
        return [(slice(i, min(i + step, n)), slice(0, r))
                for i in range(0, n, step)]
    step = max(1, CHUNK // max(c, 1))
    return [(slice(i, i + 1), slice(j, min(j + step, r)))
            for i in range(n) for j in range(0, r, step)]


def adafactor(lr: float = 1e-2, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments for matrices (ndim >= 2: row and column
    means of g² over the last two axes, rank-1 reconstruction); full for
    vectors and scalars.  State in float32; params keep their dtype.

    The reference forms the [..., r, c] float32 scale of a matrix leaf at
    once; here each leaf runs in pieces of whole rows (``_pieces``):
    one pass for the row and column sums of g² (float32 sums of the exact
    float32 squares, as its ``preferred_element_type=float32`` einsums
    give, with no float32 copy of g beyond a piece), one for the clip's
    RMS, one for the update."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"s": tree_map(leaf, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}

    def _finish(g, scale, rms2):
        """The clipped update g·scale / clip in g's dtype (the division in
        float32, rounded once)."""
        clip = torch.clamp(torch.sqrt(rms2 + eps)
                           / torch.full((), clip_threshold,
                                        dtype=torch.float32,
                                        device=g.device), min=1.0)
        gs = g * scale.to(g.dtype)
        return (gs.to(torch.float32) / clip.to(g.dtype).to(torch.float32)
                ).to(g.dtype)

    def matrix(g, s, p, beta2):
        shape = g.shape
        r, c = shape[-2], shape[-1]
        g3, p3 = g.reshape(-1, r, c), p.reshape(-1, r, c)
        pieces = _pieces(g3.shape[0], r, c)
        g2r = torch.empty(g3.shape[:2], dtype=torch.float32, device=g.device)
        g2c = torch.zeros((g3.shape[0], c), dtype=torch.float32,
                          device=g.device)
        for mats, rows in pieces:
            sq = g3[mats, rows].to(torch.float32).square()
            g2r[mats, rows] = sq.sum(-1)
            g2c[mats] += sq.sum(-2)
        g2r = _fdiv(g2r, c).reshape(shape[:-1])
        g2c = _fdiv(g2c, r).reshape(shape[:-2] + shape[-1:])
        vr = beta2 * s["vr"] + (1 - beta2) * (g2r + eps)
        vc = beta2 * s["vc"] + (1 - beta2) * (g2c + eps)
        vr3, vc3 = vr.reshape(-1, r), vc.reshape(-1, c)
        mean = torch.clamp(_fdiv(vr3.sum(-1), r), min=eps)

        def scale_of(mats, rows):
            # rank-1 reconstruction of the second moment, one piece
            denom = vr3[mats, rows, None] * vc3[mats, None, :] \
                / mean[mats, None, None]
            return torch.rsqrt(torch.clamp(denom, min=eps))

        rms2 = torch.zeros((), dtype=torch.float32, device=g.device)
        for mats, rows in pieces:
            gp = g3[mats, rows]
            sc = scale_of(mats, rows).to(g.dtype)
            rms2 = rms2 + (gp.to(torch.float32)
                           * (gp * sc ** 2).to(torch.float32)).sum()
        rms2 = _fdiv(rms2, g.numel())
        new_p = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        new3 = new_p.view(-1, r, c)
        for mats, rows in pieces:
            upd = _finish(g3[mats, rows], scale_of(mats, rows), rms2)
            new3[mats, rows] = (p3[mats, rows] - lr * upd).to(p.dtype)
        return new_p, {"vr": vr, "vc": vc}

    def vector(g, s, p, beta2):
        g32 = g.to(torch.float32)
        v = beta2 * s["v"] + (1 - beta2) * (g32 * g32 + eps)
        scale = torch.rsqrt(torch.clamp(v, min=eps))
        rms2 = torch.mean((g32 * scale) ** 2)
        upd = _finish(g, scale, rms2)
        return (p - lr * upd).to(p.dtype), {"v": v}

    def update(grads, state, params):
        t = state["t"] + 1
        beta2 = 1.0 - t.to(torch.float32) ** -0.8
        outs = [(matrix if _factored(p.shape) else vector)(g, s, p, beta2)
                for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                                   _state_leaves(params, state["s"]))]
        new_p, new_s = _unzip(params, outs, 2)
        return new_p, {"s": new_s, "t": t}

    return Optimizer(init, update)


def _state_leaves(params, s) -> list:
    """Adafactor's per-leaf state dicts in ``tree_leaves(params)`` order
    (``s`` has ``params``' structure with a dict at each leaf)."""
    if isinstance(params, dict):
        return [x for k in params for x in _state_leaves(params[k], s[k])]
    if isinstance(params, (list, tuple)):
        return [x for i, v in enumerate(params)
                for x in _state_leaves(v, s[i])]
    return [s]


@dataclasses.dataclass(frozen=True)
class WarmupLinearLR:
    """LR ramp used with the large-batch schedule (paper §7.1 pairs the
    warm-up batch with linearly-scaled LR): peak_lr · min(1, t / warmup),
    in float32 as the reference computes it.  The division is by a float32
    tensor: torch would multiply by the reciprocal of a Python scalar."""
    peak_lr: float
    warmup_steps: int

    def __call__(self, t) -> torch.Tensor:
        tf = torch.as_tensor(t).to(torch.float32)
        ramp = tf / torch.full((), float(max(self.warmup_steps, 1)),
                               dtype=torch.float32, device=tf.device)
        return self.peak_lr * torch.clamp(ramp, max=1.0)


def global_norm_clip(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / ‖grads‖), ‖grads‖): the global
    float32 L2 norm over every leaf, summed in the reference's leaf order
    (``tree_paths``: dict keys sorted).  The scale is a float32 tensor, so
    bfloat16 gradients come back float32, as the reference's do."""
    leaves = [g for _, g in tree_paths(grads)]
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in leaves))
    scale = torch.clamp(torch.full((), float(max_norm), dtype=torch.float32,
                                   device=norm.device)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: _up(g, scale) * scale, grads), norm
