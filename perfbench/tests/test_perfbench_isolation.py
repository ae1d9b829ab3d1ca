"""What the benchmark may import and read, and that it is driven by data:
a new mix resolves by name without an edit to any file."""
import ast
import json
import pathlib
import shutil

from perfbench.harness import bench

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports (whole names:
    ``repro_torch`` is not ``repro``), also those imported by string."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def _sources():
    return sorted(PERFBENCH.rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PERFBENCH / "reference").rglob("*.py")):
        names = _imports(path)
        assert "repro_torch" not in names, path
        assert not any("repro_torch" in line for line in
                       path.read_text().splitlines()
                       if "import" in line), path


def test_nothing_reads_the_jax_benchmarks():
    for path in list(_sources()) + sorted(PERFBENCH.rglob("*.json")):
        text = path.read_text()
        if path.name == "test_perfbench_isolation.py":
            continue
        assert "benchmarks/" not in text and "BENCH_" not in text, path


def test_a_new_mix_resolves_by_name(tmp_path):
    root = tmp_path / "perfbench"
    for sub in ("configs", "mixes", "limits", "metrics"):
        shutil.copytree(PERFBENCH / sub, root / sub)
    bench_json = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
    (tmp_path / "perfbench" / "configs").mkdir(exist_ok=True)
    mix = {"kind": "serve", "why": "uniform users", "k": 20,
           "overrides": {"eval.k": 20}, "rate_per_s": 100.0,
           "user_alpha": 0.0, "warm_seconds": 1.0, "drain_seconds": 60.0,
           "trace_seconds": 1.0}
    (root / "mixes" / "serve-uniform-test.json").write_text(json.dumps(mix))
    bench_json["workloads"].append(
        {"name": "lightgcn-serve-uniform-test", "config": "lightgcn-full",
         "traffic": "serve-uniform-test", "chips": 1, "why": "test"})
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if "lightgcn-serve-zipf" in m.get("workloads", ()):
            m["workloads"].append("lightgcn-serve-uniform-test")
    cell = bench.resolve("lightgcn-serve-uniform-test", bench=bench_json,
                         root=root)
    assert cell.mix == mix and cell.kind == "serve"
    assert cell.config["name"] == "lightgcn-full"
    names = {m["name"] for m in cell.end_to_end}
    assert names == {"setup_s", "serve_p50_ms"}
    assert {m["name"] for m in cell.per_layer} >= {"batch_occupancy.serve"}
    reader = bench.metric_reader("batch_occupancy.serve", root=root)
    assert callable(reader)


def test_every_cell_and_metric_resolves():
    b = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = bench.resolve(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
            assert callable(bench.metric_reader(m["name"]))
