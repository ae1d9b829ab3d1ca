"""Layer 1b — registry-completeness rules over the port's surfaces (the
port of ``repro/analysis/repo_rules.py``; cross-file, AST + JSON only).

  * every ``kernels/ops.py`` dispatch entry (a public function with an
    ``impl=`` keyword) needs a ``<name>_ref`` plain version in
    ``kernels/ref.py`` and coverage in ``tests/test_torch_kernels.py``;
  * every ``*Cfg`` dataclass in ``api/spec.py`` must be registered in
    ``_SECTIONS`` (or ``from_dict`` silently drops it) and named by a
    test somewhere under ``tests/``;
  * every registered ``TierTopology`` preset (``h100-hbm-host`` among
    them) needs its golden arms (``<name>`` and ``<name>@int8``) in the
    port's ``analysis/plan_snapshots.json``
    (``python -m repro_torch.analysis --update-snapshots`` writes it);
  * every CUDA library of ``kernels/_build.py::SIGNATURES`` needs a
    ``cuda``-marked test in ``tests/test_torch_cuda.py`` that names it and
    a row in ``chip_smoke.py``'s ``KERNELS`` whose source is its
    ``csrc/<name>.cu``: the standing contract that every kernel is held
    against its plain version on the card.

Rule catalogue:

  reg-kernel-oracle       ops.py dispatch def without a ``<name>_ref``
                          in ref.py.
  reg-kernel-parity-test  ops.py dispatch def never named in
                          tests/test_torch_kernels.py.
  reg-spec-section        a ``*Cfg`` dataclass in api/spec.py missing
                          from the ``_SECTIONS`` table.
  reg-spec-roundtrip      a ``*Cfg`` dataclass never named under tests/.
  reg-topology-snapshot   a registered topology preset without its fp32
                          or @int8 golden arm in plan_snapshots.json.
  reg-kernel-card-test    a CUDA library without a cuda-marked test in
                          tests/test_torch_cuda.py that names it.
  reg-kernel-smoke-row    a CUDA library without a row in chip_smoke.py's
                          KERNELS.
"""
from __future__ import annotations

import ast
import json
import pathlib

from repro_torch.analysis.rules import Finding

__all__ = ["REPO_RULES", "lint_repo"]

REPO_RULES = {
    "reg-kernel-oracle": "kernels/ops.py dispatch entry without a "
                         "kernels/ref.py plain version",
    "reg-kernel-parity-test": "kernels/ops.py dispatch entry not covered "
                              "by tests/test_torch_kernels.py",
    "reg-spec-section": "*Cfg dataclass in api/spec.py missing from "
                        "_SECTIONS",
    "reg-spec-roundtrip": "*Cfg dataclass with no test referencing it "
                          "under tests/",
    "reg-topology-snapshot": "registered TierTopology preset without its "
                             "golden plan-snapshot arm",
    "reg-kernel-card-test": "CUDA library without a cuda-marked test in "
                            "tests/test_torch_cuda.py",
    "reg-kernel-smoke-row": "CUDA library without a row in chip_smoke.py's "
                            "KERNELS",
}

# registry surfaces, relative to the repo root
_PKG = "src/repro_torch"
_OPS = f"{_PKG}/kernels/ops.py"
_REF = f"{_PKG}/kernels/ref.py"
_BUILD = f"{_PKG}/kernels/_build.py"
_PARITY = "tests/test_torch_kernels.py"
_CARD_TESTS = "tests/test_torch_cuda.py"
_SMOKE = "chip_smoke.py"
_SPEC = f"{_PKG}/api/spec.py"
_TOPOLOGY = f"{_PKG}/memory/topology.py"
_SNAPSHOTS = f"{_PKG}/analysis/plan_snapshots.json"
_TESTS_DIR = "tests"


def _parse(root: pathlib.Path, rel: str) -> ast.Module:
    return ast.parse((root / rel).read_text(), filename=rel)


def _top_level_defs(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _finding(rule: str, rel: str, line: int, message: str) -> Finding:
    # registry findings fingerprint on the message, not a source line:
    # they describe a missing thing, so there is no offending line text
    return Finding(rule, rel, line, 0, message, message)


def _is_dispatch(fn: ast.FunctionDef) -> bool:
    """A public def with an ``impl`` parameter that has a default."""
    if fn.name.startswith("_"):
        return False
    a = fn.args
    pos = a.posonlyargs + a.args
    defaulted = {p.arg for p in pos[len(pos) - len(a.defaults):]}
    defaulted |= {p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None}
    return "impl" in defaulted


def _kernel_rules(root: pathlib.Path) -> list[Finding]:
    out: list[Finding] = []
    dispatch = {name: fn.lineno
                for name, fn in _top_level_defs(_parse(root, _OPS)).items()
                if _is_dispatch(fn)}
    oracles = set(_top_level_defs(_parse(root, _REF)))
    parity_src = (root / _PARITY).read_text()
    for name, line in sorted(dispatch.items()):
        if f"{name}_ref" not in oracles:
            out.append(_finding(
                "reg-kernel-oracle", _OPS, line,
                f"dispatch `{name}` has no `{name}_ref` plain version in "
                f"{_REF}"))
        if name not in parity_src:
            out.append(_finding(
                "reg-kernel-parity-test", _OPS, line,
                f"dispatch `{name}` is never referenced in {_PARITY}"))
    return out


def _dict_assign(tree: ast.Module, name: str):
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            return node
    return None


def _spec_rules(root: pathlib.Path) -> list[Finding]:
    out: list[Finding] = []
    tree = _parse(root, _SPEC)
    cfgs = {n.name: n.lineno for n in tree.body
            if isinstance(n, ast.ClassDef) and n.name.endswith("Cfg")}
    sections = _dict_assign(tree, "_SECTIONS")
    section_values = {v.id for v in sections.value.values
                      if isinstance(v, ast.Name)} if sections else set()
    tests_src = "\n".join(p.read_text() for p in
                          sorted((root / _TESTS_DIR).glob("*.py")))
    for name, line in sorted(cfgs.items()):
        if name not in section_values:
            out.append(_finding(
                "reg-spec-section", _SPEC, line,
                f"`{name}` is not registered in _SECTIONS — from_dict "
                "will silently drop the section"))
        if name not in tests_src:
            out.append(_finding(
                "reg-spec-roundtrip", _SPEC, line,
                f"`{name}` is never referenced under {_TESTS_DIR}/ — "
                "no round-trip coverage"))
    return out


def _registered_topologies(tree: ast.Module) -> dict[str, int]:
    """Preset names from ``register_topology(TierTopology("<name>", ...)``
    call sites (string-literal first arguments only)."""
    names: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        head = node.func
        if not (isinstance(head, ast.Name)
                and head.id == "register_topology") and not (
                isinstance(head, ast.Attribute)
                and head.attr == "register_topology"):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Call) and arg.args \
                    and isinstance(arg.args[0], ast.Constant) \
                    and isinstance(arg.args[0].value, str):
                names[arg.args[0].value] = node.lineno
    return names


def _topology_rules(root: pathlib.Path) -> list[Finding]:
    out: list[Finding] = []
    topos = _registered_topologies(_parse(root, _TOPOLOGY))
    snap_path = root / _SNAPSHOTS
    keys = set(json.loads(snap_path.read_text())) if snap_path.exists() \
        else set()
    for name, line in sorted(topos.items()):
        for arm in (name, f"{name}@int8"):
            if arm not in keys:
                out.append(_finding(
                    "reg-topology-snapshot", _TOPOLOGY, line,
                    f"topology `{name}` has no `{arm}` golden arm in "
                    f"{_SNAPSHOTS} (run python -m repro_torch.analysis "
                    "--update-snapshots)"))
    return out


def _cuda_marked(tree: ast.Module) -> bool:
    """Whether the module sets ``pytestmark`` to (a list holding)
    ``pytest.mark.cuda``."""
    node = next((n for n in tree.body if isinstance(n, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                         for t in n.targets)), None)
    return node is not None and any(
        isinstance(n, ast.Attribute) and n.attr == "cuda"
        for n in ast.walk(node.value))


def _card_tests(root: pathlib.Path) -> list[str]:
    """The source of every cuda-marked test function of the card's file."""
    src = (root / _CARD_TESTS).read_text()
    tree = ast.parse(src, filename=_CARD_TESTS)
    marked_module = _cuda_marked(tree)
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test")):
            continue
        marked = marked_module or any(
            isinstance(n, ast.Attribute) and n.attr == "cuda"
            for d in fn.decorator_list for n in ast.walk(d))
        if marked:
            out.append(ast.get_source_segment(src, fn) or "")
    return out


def _smoke_sources(root: pathlib.Path) -> set[str]:
    """The ``source`` of every row of chip_smoke.py's ``KERNELS``."""
    node = _dict_assign(_parse(root, _SMOKE), "KERNELS")
    if node is None:
        return set()
    return {v.elts[0].value for v in node.value.values
            if isinstance(v, ast.Tuple) and v.elts
            and isinstance(v.elts[0], ast.Constant)}


def _card_rules(root: pathlib.Path) -> list[Finding]:
    out: list[Finding] = []
    sigs = _dict_assign(_parse(root, _BUILD), "SIGNATURES")
    libs = {k.value: k.lineno for k in (sigs.value.keys if sigs else [])
            if isinstance(k, ast.Constant)}
    tests = _card_tests(root)
    rows = _smoke_sources(root)
    for name, line in sorted(libs.items()):
        if not any(name in t for t in tests):
            out.append(_finding(
                "reg-kernel-card-test", _BUILD, line,
                f"library `{name}` has no cuda-marked test naming it in "
                f"{_CARD_TESTS}"))
        if f"{_PKG}/kernels/csrc/{name}.cu" not in rows:
            out.append(_finding(
                "reg-kernel-smoke-row", _BUILD, line,
                f"library `{name}` has no row with source "
                f"{_PKG}/kernels/csrc/{name}.cu in {_SMOKE}'s KERNELS"))
    return out


def lint_repo(root: "pathlib.Path | str") -> list[Finding]:
    """Run every registry-completeness rule against the repo at
    ``root``.  Surfaces that don't exist are skipped (the rules are
    repo-shape-specific by design)."""
    root = pathlib.Path(root)
    out: list[Finding] = []
    if all((root / p).exists() for p in (_OPS, _REF, _PARITY)):
        out.extend(_kernel_rules(root))
    if (root / _SPEC).exists() and (root / _TESTS_DIR).is_dir():
        out.extend(_spec_rules(root))
    if (root / _TOPOLOGY).exists():
        out.extend(_topology_rules(root))
    if all((root / p).exists() for p in (_BUILD, _CARD_TESTS, _SMOKE)):
        out.extend(_card_rules(root))
    return sorted(out, key=lambda x: (x.path, x.line, x.rule))
