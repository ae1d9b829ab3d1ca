"""Layer 1 — torch-aware AST lint (the port of ``repro/analysis/rules.py``;
no torch import needed).

The paper's placement and write-policy wins (§5-§6) die from bug classes
that type checkers don't see.  On the card the worst is a hidden host
wait: ``.item()``, ``.tolist()``, ``.cpu()``, ``float(t)`` or
``torch.tensor(x, device="cuda")`` makes the host wait for the stream, and
one of them per step or per layer costs more than a kernel.  An unseeded
sampler makes a run unreproducible, and a float64 tensor doubles every
byte the paper counts.  These rules catch all of that statically, from
the AST alone.

Rule catalogue (each finding is ``path:line:col: rule: message``;
fingerprints — ``Finding.key`` — are line-number-free, so the ratchet
baseline survives unrelated edits):

  sync-item             ``.item()``/``.tolist()`` inside a hot-path
                        function — a device->host read per call.
  sync-host-copy        ``.cpu()``/``.numpy()``/``.to("cpu")``, or a
                        numpy call on a tensor, inside a hot-path
                        function.
  sync-host-cast        ``float()``/``int()``/``bool()`` of a tensor
                        inside a hot-path function.
  sync-scalar-to-device ``torch.tensor(<scalar>, device=...)`` anywhere:
                        a copy from pageable memory that waits for the
                        stream (use ``torch.full((), x, device=...)``).
  prng-unseeded         legacy global-state ``np.random.*`` calls, a
                        seedless ``default_rng()``, or a torch sampler
                        without ``generator=``.
  prng-key-reuse        two generators seeded from the same expression
                        in one function — identical streams.
  f64-dtypeless         a dtype-less numpy constructor (float64 by
                        default; torch's default is float32) whose
                        result reaches ``torch.from_numpy``/
                        ``torch.as_tensor``/``torch.tensor``.
  f64-explicit          explicit float64: numpy's and torch's float64
                        dtypes, ``torch.double``, ``.double()``,
                        float64 dtype strings, ``astype(float)``.

The hot path is ``HOT_PATH``: ``module::qualname`` entries, the port's
counterparts of the reference's ``jax.jit`` sites (the engine's micro
step and update, the kernels' dispatch and card wrappers, the models'
step functions, the legacy trainers' steps).  Nested functions inherit
the hot context.  Inside one, a function's parameters are tensors unless
annotated ``int``/``float``/``bool``/``str``/``np.ndarray`` or
keyword-only, and ``x.shape``/``x.dtype``/``x.data_ptr()``/``len(x)`` are
metadata, not values.

``COUNTERPARTS`` maps each of the reference's nine rules to its
counterpart here; ``NOT_PORTED`` holds the two without one.
"""
from __future__ import annotations

import ast
import builtins
import dataclasses
import pathlib

__all__ = ["Finding", "RULES", "COUNTERPARTS", "NOT_PORTED", "HOT_PATH",
           "lint_source", "lint_paths"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation, with a line-number-free baseline fingerprint."""
    rule: str
    path: str                 # repo-relative posix path
    line: int
    col: int
    message: str
    snippet: str              # stripped source line (ratchet fingerprint)

    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.snippet}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


# rule name -> one-line description (`python -m repro_torch.analysis
# --rules` prints it; tests assert every implemented rule is here)
RULES = {
    "sync-item": "`.item()`/`.tolist()` inside a hot-path function is a "
                 "device->host read per call",
    "sync-host-copy": "`.cpu()`/`.numpy()`/`.to('cpu')` or a numpy call on "
                      "a tensor inside a hot-path function",
    "sync-host-cast": "float()/int()/bool() of a tensor inside a hot-path "
                      "function",
    "sync-scalar-to-device": "torch.tensor(<scalar>, device=...) copies from "
                             "pageable memory and waits for the stream",
    "prng-unseeded": "global-state np.random.* call, seedless "
                     "default_rng(), or torch sampler without generator= "
                     "— unreproducible",
    "prng-key-reuse": "two generators seeded from the same expression in "
                      "one function — identical streams",
    "f64-dtypeless": "dtype-less numpy constructor (float64) reaching "
                     "torch.from_numpy/as_tensor/tensor",
    "f64-explicit": "explicit float64 dtype in repo code (fp32-only hot "
                    "paths)",
}

# the reference's rule -> its counterpart here (None: in NOT_PORTED)
COUNTERPARTS = {
    "tracer-item": "sync-item",
    "tracer-host-cast": "sync-host-cast",
    "tracer-np-call": "sync-host-copy",
    "prng-unseeded": "prng-unseeded",
    "prng-key-reuse": "prng-key-reuse",
    "f64-dtypeless": "f64-dtypeless",
    "f64-explicit": "f64-explicit",
    "pallas-python-branch": None,
    "pallas-nonstatic-grid": None,
}

NOT_PORTED = {
    "pallas-python-branch": "the port's kernels are CUDA C++ behind ctypes "
                            "(kernels/_build.py), not traced Python; a "
                            "Python branch in eager code runs each call "
                            "and is no hazard",
    "pallas-nonstatic-grid": "a CUDA launch's grid is computed on the host "
                             "for each call; there is no trace for it to "
                             "be baked into",
}

# module::qualname of every hot-path function (nested defs inherit)
HOT_PATH = frozenset({
    # the engine's jitted halves (repro/pipeline/engine.py:174, :183)
    "repro_torch.pipeline.engine::Pipeline.loss",
    "repro_torch.pipeline.engine::Pipeline.value_and_grad",
    "repro_torch.pipeline.engine::Pipeline.apply_update",
    # the jitted kernels' dispatch and the card wrappers behind it
    "repro_torch.kernels.ops::sddmm",
    "repro_torch.kernels.ops::spmm_csr",
    "repro_torch.kernels.ops::hadamard_spmm",
    "repro_torch.kernels.ops::embedding_bag",
    "repro_torch.kernels.ops::fused_topk_score",
    "repro_torch.kernels.ops::ann_block_scores",
    "repro_torch.kernels.spmm::spmm_csr_cuda",
    "repro_torch.kernels.hadamard_spmm::hadamard_spmm_cuda",
    "repro_torch.kernels.embedding_bag::embedding_bag_cuda",
    "repro_torch.kernels.topk_score::fused_topk_score_cuda",
    "repro_torch.kernels.ann::ann_block_scores_cuda",
    # jitted helpers: sparse ops, degrees, serving's row gathers
    "repro_torch.core.sparse_ops::sddmm",
    "repro_torch.core.sparse_ops::spmm",
    "repro_torch.core.sparse_ops::edge_softmax",
    "repro_torch.core.graph::degrees",
    "repro_torch.eval.topk::_gather_rows",
    "repro_torch.serving.ann::_gather_candidates",
    # the models' step functions
    "repro_torch.core.train_step::value_and_grad",
    "repro_torch.core.train_step::bpr_value_and_grad",
    "repro_torch.core.train_step::full_graph_step",
    "repro_torch.models.transformer::forward",
    "repro_torch.models.transformer::lm_loss",
    "repro_torch.models.transformer::train_step",
    "repro_torch.models.transformer::prefill",
    # the legacy trainers' jitted steps (repro/launch/train.py:252, :281)
    "repro_torch.launch.train::gcn_train_step",
    "repro_torch.launch.train::recsys_train_step",
    "repro_torch.launch.train::dlrm_rowwise_step",
})

_LEGACY_NP_RANDOM = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "beta", "binomial", "exponential", "gamma",
    "poisson", "seed",
}
_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
}
_INPLACE_SAMPLERS = {
    "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
    "cauchy_", "log_normal_", "geometric_",
}
_NP_DTYPELESS = {"zeros", "ones", "empty", "full", "linspace"}
_TO_TORCH = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}
# float64 by name; spelled as strings so this file has none of them
_F64_NAME = "float" + "64"
_F64_CHAINS = {f"{m}.{_F64_NAME}" for m in ("np", "numpy", "jnp",
                                             "jax.numpy", "torch")} \
    | {"torch.double"}
_STATIC_ANNOTATIONS = {"int", "float", "bool", "str", "np.ndarray"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "numel", "dim", "data_ptr", "stride", "element_size",
                 "is_contiguous", "is_pinned"}
_BUILTINS = set(dir(builtins))


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain ('' when not a chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _value_names_in(node: ast.AST) -> set[str]:
    """Names referenced by ``node`` in value position — uses under
    ``x.shape``/``x.dtype``/``len(x)`` are metadata and don't count."""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return set()
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return set()
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _STATIC_ATTRS:
            return set()
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
        # the iterables count only where the element uses their items'
        # values: `all(t.data_ptr() % 16 == 0 for t in ts)` reads none
        targets = {n.id for g in node.generators for n in ast.walk(g.target)
                   if isinstance(n, ast.Name)}
        elt = _value_names_in(node.elt)
        for g in node.generators:
            for cond in g.ifs:
                elt |= _value_names_in(cond)
        out = elt - targets
        if elt & targets:
            for g in node.generators:
                out |= _value_names_in(g.iter)
        return out
    out: set[str] = set()
    for child in ast.iter_child_nodes(node):
        out |= _value_names_in(child)
    return out


def _is_static_param(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return arg.arg in ("self", "cls")
    text = ast.unparse(ann).replace(" ", "")
    return any(text == t or text in (f"{t}|None", f"None|{t}")
               for t in _STATIC_ANNOTATIONS)


def _kwarg(call: ast.Call, name: str):
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


def _is_cpu_literal(node) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


class _FunctionLinter:
    """Taint-tracks one hot-path function body: which locals derive from
    its tensor parameters, then reports host reads."""

    def __init__(self, fn, emit, outer: set[str] | None = None):
        self.fn = fn
        self.emit = emit
        a = fn.args
        params = a.posonlyargs + a.args + ([a.vararg] if a.vararg else [])
        self.dynamic = {p.arg for p in params if not _is_static_param(p)}
        self.dynamic |= outer or set()

    def tainted(self, node: ast.AST) -> bool:
        return bool(_value_names_in(node) & self.dynamic)

    def run(self) -> None:
        for stmt in self.fn.body:
            self._walk(stmt)

    def _walk(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.Lambda)):
            # nested defs and lambdas inherit this function's context
            if isinstance(node, ast.Lambda):
                node = ast.FunctionDef(name="<lambda>", args=node.args,
                                       body=[ast.Expr(node.body)],
                                       decorator_list=[])
            _FunctionLinter(node, self.emit, self.dynamic).run()
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._track_assign(node)
        if isinstance(node, ast.For) and self.tainted(node.iter):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    self.dynamic.add(n.id)
        if isinstance(node, ast.Call):
            self._check_call(node)
        for child in ast.iter_child_nodes(node):
            self._walk(child)

    def _track_assign(self, node) -> None:
        value = getattr(node, "value", None)
        if value is None:
            return
        taint = self.tainted(value)
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    if taint:
                        self.dynamic.add(n.id)
                    else:
                        self.dynamic.discard(n.id)

    def _check_call(self, call: ast.Call) -> None:
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr in ("item", "tolist") and not call.args \
                    and not call.keywords:
                self.emit("sync-item", call,
                          f"`.{func.attr}()` inside a hot-path function "
                          "reads the device back per call")
                return
            if func.attr in ("cpu", "numpy") and not call.args \
                    or func.attr == "to" and call.args \
                    and _is_cpu_literal(call.args[0]):
                self.emit("sync-host-copy", call,
                          f"`.{func.attr}()` to the host inside a hot-path "
                          "function waits for the device")
                return
        if isinstance(func, ast.Name) and func.id in ("float", "int",
                                                      "bool") \
                and len(call.args) == 1 and self.tainted(call.args[0]):
            self.emit("sync-host-cast", call,
                      f"`{func.id}()` of a tensor inside a hot-path "
                      "function reads it back (device->host wait)")
            return
        chain = _attr_chain(func)
        if (chain.startswith("np.") or chain.startswith("numpy.")) \
                and any(self.tainted(a) for a in call.args):
            self.emit("sync-host-copy", call,
                      f"`{chain}()` on a tensor inside a hot-path function "
                      "copies it to the host")


class _ModuleLinter:
    def __init__(self, tree: ast.Module, src: str, path: str,
                 hot_path: bool, hot: set[str]):
        self.tree = tree
        self.lines = src.splitlines()
        self.path = path
        self.hot_path = hot_path
        self.hot = hot
        self.findings: list[Finding] = []

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        snippet = self.lines[line - 1].strip() if \
            0 < line <= len(self.lines) else ""
        self.findings.append(Finding(rule, self.path, line,
                                     getattr(node, "col_offset", 0),
                                     message, snippet))

    def run(self) -> list[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_prng_unseeded(node)
                self._check_scalar_to_device(node)
                self._check_f64_call(node)
            if isinstance(node, ast.Attribute) \
                    and _attr_chain(node) in _F64_CHAINS:
                self.emit("f64-explicit", node,
                          f"explicit {_attr_chain(node)} (hot paths are "
                          "fp32-only)")
        scopes = [self.tree] + [n for n in ast.walk(self.tree)
                                if isinstance(n, ast.FunctionDef)]
        for scope in scopes:
            self._check_key_reuse(scope)
            if self.hot_path:
                self._check_dtypeless(scope)
        self._functions(self.tree, prefix="")
        return self.findings

    # ----------------------------------------------------- module rules
    def _check_prng_unseeded(self, call: ast.Call) -> None:
        chain = _attr_chain(call.func)
        parts = chain.split(".")
        if len(parts) == 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" and parts[2] in _LEGACY_NP_RANDOM:
            self.emit("prng-unseeded", call,
                      f"legacy global-state `{chain}()` — seed a "
                      "`np.random.default_rng(seed)` instead")
        elif chain.endswith("default_rng") and not call.args \
                and not call.keywords:
            self.emit("prng-unseeded", call,
                      "`default_rng()` without a seed is unreproducible")
        elif (len(parts) == 2 and parts[0] == "torch"
              and parts[1] in _TORCH_SAMPLERS
              or isinstance(call.func, ast.Attribute)
              and call.func.attr in _INPLACE_SAMPLERS) \
                and _kwarg(call, "generator") is None:
            name = chain or f".{call.func.attr}"
            self.emit("prng-unseeded", call,
                      f"`{name}()` without generator= draws from the global "
                      "generator — pass a seeded torch.Generator")

    def _check_scalar_to_device(self, call: ast.Call) -> None:
        if _attr_chain(call.func) != "torch.tensor" or not call.args:
            return
        dev = _kwarg(call, "device")
        if dev is None or _is_cpu_literal(dev):
            return
        data = call.args[0]
        if isinstance(data, (ast.List, ast.Tuple, ast.ListComp, ast.Set,
                             ast.GeneratorExp, ast.Dict)):
            return
        self.emit("sync-scalar-to-device", call,
                  "torch.tensor(<scalar>, device=...) copies from pageable "
                  "memory and waits for the stream — use torch.full((), "
                  "x, dtype=..., device=...)")

    def _check_f64_call(self, call: ast.Call) -> None:
        """float64 as a dtype string (a dtype= kwarg, an astype()/view()
        argument), ``astype(float)`` and ``.double()``."""
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "double" \
                and not call.args:
            self.emit("f64-explicit", call,
                      "`.double()` is float64 — use an explicit 32-bit "
                      "dtype")
            return
        hits = [kw.value for kw in call.keywords if kw.arg == "dtype"]
        if isinstance(func, ast.Attribute) and func.attr in ("astype",
                                                             "view"):
            hits += list(call.args)
        for node in hits:
            if isinstance(node, ast.Constant) and node.value == _F64_NAME:
                self.emit("f64-explicit", node,
                          "float64 dtype string (hot paths are fp32-only)")
        if isinstance(func, ast.Attribute) and func.attr == "astype" \
                and len(call.args) == 1 and isinstance(call.args[0], ast.Name) \
                and call.args[0].id == "float":
            self.emit("f64-explicit", call,
                      "`astype(float)` is float64 — use an explicit 32-bit "
                      "dtype")

    @staticmethod
    def _own_nodes(scope):
        """The nodes of ``scope`` outside its nested function defs."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef, ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))

    def _check_key_reuse(self, scope) -> None:
        seeds: dict[str, list[ast.Call]] = {}
        for node in self._own_nodes(scope):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            chain = _attr_chain(node.func)
            if chain.endswith("default_rng") or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "manual_seed"):
                seeds.setdefault(ast.dump(node.args[0]), []).append(node)
        for calls in seeds.values():
            for call in sorted(calls, key=lambda c: (c.lineno,
                                                     c.col_offset))[1:]:
                self.emit("prng-key-reuse", call,
                          "a second generator seeded from the same "
                          "expression gives the same stream — derive a "
                          "distinct seed")

    def _dtypeless_np(self, node) -> bool:
        if not isinstance(node, ast.Call):
            return False
        chain = _attr_chain(node.func)
        head, _, name = chain.rpartition(".")
        if head not in ("np", "numpy") or _kwarg(node, "dtype") is not None:
            return False
        if name in _NP_DTYPELESS:
            need = {"full": 3, "linspace": 4}.get(name, 2)
            return len(node.args) < need
        if name in ("array", "asarray") and len(node.args) == 1:
            return any(isinstance(n, ast.Constant)
                       and isinstance(n.value, float)
                       for n in ast.walk(node.args[0]))
        return False

    def _check_dtypeless(self, scope) -> None:
        f64_names: set[str] = set()
        for node in sorted((n for n in self._own_nodes(scope)
                            if isinstance(n, (ast.Assign, ast.Call))),
                           key=lambda n: (n.lineno, n.col_offset)):
            if isinstance(node, ast.Assign):
                names = {t.id for t in node.targets
                         if isinstance(t, ast.Name)}
                if self._dtypeless_np(node.value):
                    f64_names |= names
                else:
                    f64_names -= names
                continue
            if _attr_chain(node.func) not in _TO_TORCH or not node.args \
                    or _kwarg(node, "dtype") is not None:
                continue
            data = node.args[0]
            if self._dtypeless_np(data) or (isinstance(data, ast.Name)
                                            and data.id in f64_names):
                self.emit("f64-dtypeless", node,
                          "a dtype-less numpy array (float64) becomes a "
                          "float64 tensor — give numpy a 32-bit dtype")

    # --------------------------------------------------- function rules
    def _functions(self, scope, prefix: str) -> None:
        for node in ast.iter_child_nodes(scope):
            if isinstance(node, ast.FunctionDef):
                qual = f"{prefix}{node.name}"
                if qual in self.hot:
                    _FunctionLinter(node, self.emit).run()
                else:
                    self._functions(node, f"{qual}.")
            elif isinstance(node, ast.ClassDef):
                self._functions(node, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                self._functions(node, prefix)


def module_of(path: str) -> str:
    """``src/repro_torch/a/b.py`` -> ``repro_torch.a.b`` (the part from
    the first package directory named ``repro_torch``)."""
    parts = pathlib.PurePosixPath(path).with_suffix("").parts
    if "repro_torch" not in parts:
        return ".".join(parts)
    parts = parts[parts.index("repro_torch"):]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def lint_source(src: str, path: str = "<memory>", hot_path: bool = True,
                hot: "set[str] | None" = None) -> list[Finding]:
    """Lint one module's source text.  ``hot`` names the module's
    hot-path functions by qualname (default: its ``HOT_PATH`` entries);
    ``hot_path`` gates the f64-dtypeless rule, as in the reference."""
    tree = ast.parse(src, filename=path)
    if hot is None:
        mod = module_of(path)
        hot = {e.split("::", 1)[1] for e in HOT_PATH
               if e.split("::", 1)[0] == mod}
    return _ModuleLinter(tree, src, path, hot_path, set(hot)).run()


def lint_paths(paths, root: "pathlib.Path | str | None" = None
               ) -> list[Finding]:
    """Lint every ``*.py`` under ``paths`` (files or directories).
    Paths in findings are reported relative to ``root`` when given."""
    root = pathlib.Path(root) if root is not None else None
    files: list[pathlib.Path] = []
    for p in map(pathlib.Path, paths):
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: list[Finding] = []
    for f in files:
        rel = f
        if root is not None:
            try:
                rel = f.resolve().relative_to(pathlib.Path(root).resolve())
            except ValueError:
                rel = f
        findings.extend(lint_source(f.read_text(), rel.as_posix()))
    return sorted(findings, key=lambda x: (x.path, x.line, x.rule))
