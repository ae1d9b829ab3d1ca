"""The port's launch layer (``repro_torch.launch``: mesh, shardings,
roofline, cells, dryrun) against the reference's ``repro.launch``.

The reference's cells need a JAX mesh with devices behind it, so one
subprocess with 512 forced host devices builds every cell of the 12
archs' SHAPES (39, plus the ring and row-wise variants) at one card
((1, 1) over ("data", "model")), the 16 x 16 pod and the 2 x 16 x 16 two
pods, and dumps each cell's meta, each argument's path, shape, dtype,
spec and per-device bytes (ceil division per sharded dim).  The port's
cells are held to that dump: ints exact, floats rel 1e-12, shapes,
dtypes and specs equal, per-device bytes equal.  The shardings rules,
the roofline rule with the reference's TPU constants injected, the
dry-run CLI (every record, no tensor with storage), the LM memory model
that moved out of chip_smoke.py (lm_plan's cuts pinned at a fixed free
figure) and the configs' SHAPES/SKIP are held here too."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch import shardings as jshd
from repro_torch import configs
from repro_torch.launch import cells, dryrun, mesh, roofline, shardings
from repro_torch.optim.optimizers import tree_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = {"": {}, "ring": {"REPRO_GNN_IMPL": "ring"},
            "rowwise": {"REPRO_RECSYS_OPT": "rowwise"}}
MESH_SHAPES = {"one-card": ((1, 1), ("data", "model")),
               "pod": ((16, 16), ("data", "model")),
               "two-pods": ((2, 16, 16), ("pod", "data", "model"))}
META_RTOL = 1e-12

_REF_DUMP = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, "src")
    import jax
    from repro import configs
    from repro.launch import cells as cb
    from repro.launch.mesh import make_mesh
    MESHES = {name: make_mesh(*shape) for name, shape in
              json.loads(sys.argv[1]).items()}
    VARIANTS = json.loads(sys.argv[2])

    def per_dev(shape, spec, mesh):
        spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        n = 1
        for d, e in zip(shape, spec):
            k = 1
            for a in ((e,) if isinstance(e, str) else (e or ())):
                k *= mesh.shape[a]
            n *= -(-d // k)
        return n

    out = {}
    for variant, env in VARIANTS.items():
        for k in ("REPRO_GNN_IMPL", "REPRO_RECSYS_OPT"):
            os.environ.pop(k, None)
        os.environ.update(env)
        for arch in configs.ARCH_IDS:
            mod = configs.get(arch)
            for shape, sh in mod.SHAPES.items():
                if shape in mod.SKIP or variant == "ring" \\
                        and sh["kind"] != "gnn_full" or variant == "rowwise" \\
                        and not (arch == "dlrm_rm2"
                                 and sh["kind"] == "recsys_train"):
                    continue
                for mname, mesh in MESHES.items():
                    c = cb.build_cell(arch, shape, mesh)
                    leaves = jax.tree_util.tree_flatten_with_path(c.args)[0]
                    shards = jax.tree_util.tree_leaves(c.in_shardings)
                    args = [[jax.tree_util.keystr(path), list(s.shape),
                             str(s.dtype),
                             per_dev(s.shape, sh_.spec, mesh)
                             * s.dtype.itemsize,
                             [list(e) if isinstance(e, tuple) else e
                              for e in sh_.spec]]
                            for (path, s), sh_ in zip(leaves, shards)]
                    out[f"{variant}|{arch}|{shape}|{mname}"] = {
                        "meta": c.meta, "kind": c.kind, "args": args}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _REF_DUMP, json.dumps(MESH_SHAPES),
         json.dumps(VARIANTS)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _norm_spec(spec) -> list:
    """Entries as JSON gives them, a one-axis tuple as its axis name (JAX
    stores ``('data',)`` so; the two mean one split)."""
    return [e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else list(e) if isinstance(e, tuple) else e for e in spec]


def _port_cell(variant, arch, shape, mesh_name, monkeypatch):
    for k in ("REPRO_GNN_IMPL", "REPRO_RECSYS_OPT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in VARIANTS[variant].items():
        monkeypatch.setenv(k, v)
    return cells.build_cell(arch, shape, mesh.MESHES[mesh_name])


def _meta_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) or isinstance(g, float):
            assert g == pytest.approx(w, rel=META_RTOL), k
        else:
            assert g == w, k


def _all_keys():
    keys = []
    for arch in jconfigs.ARCH_IDS:
        mod = jconfigs.get(arch)
        for shape, sh in mod.SHAPES.items():
            if shape in mod.SKIP:
                continue
            keys.append(("", arch, shape))
            if sh["kind"] == "gnn_full":
                keys.append(("ring", arch, shape))
            if arch == "dlrm_rm2" and sh["kind"] == "recsys_train":
                keys.append(("rowwise", arch, shape))
    return keys


@pytest.mark.parametrize("variant,arch,shape", _all_keys())
def test_cells_match_reference(reference_cells, variant, arch, shape,
                               monkeypatch):
    """meta (ints exact, floats rel 1e-12), kind, every argument's path,
    shape, dtype, spec and per-device bytes, at the three meshes; every
    argument without storage."""
    from torch._subclasses.fake_tensor import FakeTensor
    for mesh_name in MESH_SHAPES:
        want = reference_cells[f"{variant}|{arch}|{shape}|{mesh_name}"]
        cell = _port_cell(variant, arch, shape, mesh_name, monkeypatch)
        assert cell.kind == want["kind"]
        _meta_equal(cell.meta, want["meta"])
        m = mesh.MESHES[mesh_name]
        got = []
        for path, t in tree_paths(list(cell.args)):
            assert isinstance(t, FakeTensor), path
            # a spec is a tuple leaf: its path is the argument's path
            # plus the spec's own entry indices, so look it up by prefix
            spec = _spec_at(cell.in_specs, path)
            got.append([path, list(t.shape), str(t.dtype).split(".")[-1],
                        shardings.per_device_bytes(t.shape, t.dtype, spec, m),
                        _norm_spec(spec)])
        assert got == [a[:4] + [_norm_spec(a[4])] for a in want["args"]]
        assert dryrun.arg_bytes_per_device(cell, m) == \
            sum(a[3] for a in want["args"])


def _spec_at(specs, path: str):
    """The spec tree's leaf at an argument's tree path (``[0]['embed']``)."""
    node = list(specs)
    for part in path.strip("[]").split("]["):
        node = node[int(part)] if part.isdigit() else node[part.strip("'")]
    return node


# ------------------------------------------------------------ shardings
def _jmesh(shape):
    return types.SimpleNamespace(shape=dict(zip(shape[1], shape[0])),
                                 axis_names=shape[1])


def _jspec_tree(tree):
    from jax.sharding import PartitionSpec
    import jax
    return jax.tree.map(lambda s: _norm_spec(tuple(s)), tree,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def _tspec_tree(tree):
    if isinstance(tree, dict):
        return {k: _tspec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tspec_tree(v) for v in tree]
    return _norm_spec(tree)


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", ["nemotron_4_340b", "gemma2_2b",
                                  "granite_3_8b", "mixtral_8x7b",
                                  "kimi_k2_1t_a32b"])
def test_lm_specs_match_reference(arch, mesh_name):
    """Param specs (expert parallelism vs TP-in-expert included), the KV
    cache rule at a divisible and an indivisible batch, and the optimizer
    state's."""
    jm, m = _jmesh(MESH_SHAPES[mesh_name]), mesh.MESHES[mesh_name]
    jcfg, cfg = jconfigs.get(arch).FULL, configs.get(arch).FULL
    assert _tspec_tree(shardings.lm_param_specs(cfg, m)) == \
        _jspec_tree(jshd.lm_param_specs(jcfg, jm))
    for b in (1, 32, 128):
        assert _tspec_tree(shardings.lm_cache_specs(cfg, m, b)) == \
            _jspec_tree(jshd.lm_cache_specs(jcfg, jm, b))


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("opt", ["adam", "adafactor"])
def test_opt_state_specs_match_reference(opt, mesh_name):
    import jax
    from repro.models.transformer import init_params as jinit
    jm, m = _jmesh(MESH_SHAPES[mesh_name]), mesh.MESHES[mesh_name]
    jcfg = jconfigs.get("mixtral_8x7b").SMOKE
    cfg = configs.get("mixtral_8x7b").SMOKE
    jstruct = jax.eval_shape(lambda k: jinit(jcfg, k), jax.random.PRNGKey(0))
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 0, device="cpu")
    want = jshd.opt_state_specs(opt, jshd.lm_param_specs(jcfg, jm), jstruct)
    got = shardings.opt_state_specs(opt, shardings.lm_param_specs(cfg, m),
                                    params)
    assert _tspec_tree(got) == _jspec_tree(want)


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
def test_other_family_specs_match_reference(mesh_name):
    """gcn (replicated), recsys (tables over the whole mesh, keyed by
    the param tree's paths), gnnrecsys (lightgcn and ngcf)."""
    import jax
    from repro.models import recsys_models as jrm
    from repro_torch.models import recsys_models as rm
    jm, m = _jmesh(MESH_SHAPES[mesh_name]), mesh.MESHES[mesh_name]
    g = configs.get("gcn_cora").FULL
    assert _tspec_tree(shardings.gcn_param_specs(g, m)) == \
        _jspec_tree(jshd.gcn_param_specs(g, jm))
    for arch, init, jinit in [("deepfm", rm.deepfm_init, jrm.deepfm_init),
                              ("xdeepfm", rm.xdeepfm_init, jrm.xdeepfm_init),
                              ("dlrm_rm2", rm.dlrm_init, jrm.dlrm_init),
                              ("bert4rec", rm.bert4rec_init,
                               jrm.bert4rec_init)]:
        cfg = configs.get(arch).SMOKE
        jstruct = jax.eval_shape(lambda k: jinit(jconfigs.get(arch).SMOKE, k),
                                 jax.random.PRNGKey(0))
        got = shardings.recsys_param_specs(arch, init(cfg, 0, device="cpu"),
                                           m)
        assert _tspec_tree(got) == _jspec_tree(
            jshd.recsys_param_specs(arch, jstruct, jm)), arch
    for arch in ("lightgcn", "ngcf"):
        cfg = configs.get(arch).FULL
        assert _tspec_tree(shardings.gnnrecsys_param_specs(cfg, m, arch)) \
            == _jspec_tree(jshd.gnnrecsys_param_specs(cfg, jm, arch))


def test_per_device_bytes_pads_each_sharded_dim():
    m = mesh.MESHES["pod"]
    # 17 rows over 16 'data' shards -> 2 rows a device; 'model' of 5 cols
    # over 16 -> 1
    assert shardings.per_device_bytes((17, 5), torch.float32,
                                      (("data",), "model"), m) == 2 * 1 * 4
    assert shardings.per_device_bytes((17, 5), torch.bfloat16, (), m) == \
        17 * 5 * 2
    assert shardings.per_device_bytes(
        (4096, 8), torch.int32, (("data", "model"), None), m) == 16 * 8 * 4


def test_meshes_and_dp_axes():
    assert mesh.MESHES["one-card"] is mesh.ONE_CARD
    assert mesh.ONE_CARD.shape == {"data": 1, "model": 1}
    assert mesh.MESHES["pod"].size == 256
    assert mesh.MESHES["two-pods"].size == 512
    assert mesh.dp_axes(mesh.MESHES["two-pods"]) == ("pod", "data")
    assert mesh.all_axes(mesh.MESHES["two-pods"]) == ("pod", "data", "model")
    assert mesh.dp_size(mesh.MESHES["two-pods"]) == 32


# ------------------------------------------------------------- roofline
class _Compiled:
    def __init__(self, flops, byts, coll):
        self.c, self.coll = {"flops": flops, "bytes accessed": byts}, coll

    def cost_analysis(self):
        return self.c

    def as_text(self):
        return f"%ar = f32[{self.coll // 4}]{{0}} all-reduce(%x)"


@pytest.mark.parametrize("flops,byts,coll,chips", [
    (1e15, 1e9, 4096, 256), (1.0, 1e15, 0, 1), (3e9, 2e6, 4 << 20, 512)])
def test_analyze_matches_reference_with_its_constants(flops, byts, coll,
                                                      chips):
    """The port's rule with the reference's TPU constants injected equals
    the reference's analyze over a stub compiled program (rel 1e-12)."""
    want = jroofline.analyze(_Compiled(flops, byts, coll), chips,
                             model_flops=7e14).as_dict()
    got = roofline.analyze(flops, byts, coll, chips, model_flops=7e14,
                           peak_flops=jroofline.PEAK_FLOPS,
                           hbm_bw=jroofline.HBM_BW,
                           link_bw=jroofline.ICI_LINKS * jroofline.ICI_BW
                           ).as_dict()
    assert got["bottleneck"] == want["bottleneck"]
    for k, w in want.items():
        if k != "bottleneck":
            assert got[k] == pytest.approx(w, rel=1e-12), k


def test_h100_constants_and_collective_bytes():
    assert roofline.PEAK_BF16 == 989.4e12 and roofline.PEAK_FP32 == 66.9e12
    assert roofline.HBM_BW == 3.35e12 and roofline.NVLINK_BW == 450e9
    rec = types.SimpleNamespace
    st = roofline.collective_bytes([
        rec(name="c10d.allreduce_.default",
            tensors=((torch.float32, (64,)),)),
        rec(name="c10d._allgather_base_.default",
            tensors=((torch.float32, (128, 256)), (torch.float32, (64, 256)))),
        rec(name="c10d.send.default", tensors=((torch.int8, (8, 8)),)),
        rec(name="aten.mm.default", tensors=((torch.float32, (9, 9)),))])
    assert st.by_kind == {"all-reduce": 256, "all-gather": 128 * 256 * 4,
                          "collective-permute": 64}
    assert st.total_bytes == 256 + 128 * 256 * 4 + 64
    assert roofline.shape_bytes(torch.bfloat16, (3, 5)) == 30


# --------------------------------------------------------------- dryrun
def test_dryrun_all_meshes_writes_every_record(tmp_path, capsys):
    """``--all --mesh all``: one record per cell and mesh, each with the
    reference's keys; LM cells priced by the analytic model and the
    memory model, the others traced (FLOPs within the matmul count)."""
    assert dryrun.main(["--all", "--mesh", "all", "--out",
                        str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    n_cells = sum(len(set(configs.get(a).SHAPES) - set(configs.get(a).SKIP))
                  for a in configs.ARCH_IDS)
    assert n_cells == 39 and len(recs) == 3 * n_cells
    out = capsys.readouterr().out
    assert out.count("SKIP ") == 3
    for r in recs:
        for k in ("arg_bytes_per_dev", "peak_bytes_per_dev", "fits_hbm",
                  "roofline", "analytic", "traced", "meta"):
            assert k in r, k
        lm = r["kind"] in dryrun.LM_KINDS
        assert (r["peak_source"] == "lm_memory_model") == lm
        assert (r["traced"] is False) == lm
        assert r["peak_bytes_per_dev"] >= r["arg_bytes_per_dev"] > 0
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")


def test_dryrun_estimates_at_measured_cells():
    """The cells the chip smoke runs at their own shape fit one card."""
    for arch, shape in [("deepfm", "train_batch"), ("gcn_cora", "molecule"),
                        ("gcn_cora", "ogb_products")]:
        assert dryrun.run_cell(arch, shape, verbose=False)["fits_hbm"]


LM_PLAN_AT_79_GIB = {
    'gemma2_2b': ((26, 2, 20, 4096, 85501720576.0),
        ["prefill batch 32 -> 2: the phase's 120 s budget (6 would fit)",
         'decode batch 128 -> 20: what fits (3.49 GB of cache a sequence)',
         "train global batch 256 x 4096 -> 4 x 4096 in 4 microbatch(es): one 64-sequence microbatch's float32 logits alone are 268 GB"]),
    'granite_3_8b': ((40, 1, 11, None, None),
        ["prefill batch 32 -> 1: the phase's 120 s budget (3 would fit)",
         'decode batch 128 -> 11: what fits (5.37 GB of cache a sequence)',
         'no train_step: a 2-step adam step at 40 layer(s) needs ~202 GB (lm_train_need), 82 GB are free']),
    'mixtral_8x7b': ((1, 1, 128, 4096, 54141943808.0),
        ['depth 32 -> 1: the most a 2-step adam train_step fits beside its C2 float32 state',
         "prefill batch 32 -> 1: the phase's 120 s budget (3 would fit)",
         "train global batch 256 x 4096 -> 2 x 4096 in 2 microbatch(es): one 32-sequence microbatch's float32 logits alone are 17 GB"]),
    'kimi_k2_1t_a32b': ((1, 1, 128, None, None),
        ["depth 61 -> 1: the FULL model's 2088 GB of bf16 params exceed the card; full width kept",
         'prefill batch 32 -> 1: what fits',
         'no train_step: a 2-step adafactor step at 1 layer(s) needs ~118 GB (lm_train_need), 82 GB are free']),
    'nemotron_4_340b': ((1, 1, 128, 1024, 78421233664.0),
        ["depth 96 -> 1: the FULL model's 682 GB of bf16 params exceed the card; full width kept",
         'prefill batch 32 -> 1: what fits',
         "train global batch 256 x 4096 -> 1 x 1024 in 1 microbatch(es): one 16-sequence microbatch's float32 logits alone are 67 GB"]),
}


def test_lm_plan_cuts_pinned_at_fixed_free_memory():
    """chip_smoke.lm_plan over the memory model in launch/dryrun.py:
    (layers, prefill batch, decode batch, train seq, train need) and the
    'reduced' notes for a card with 79 GiB free, exactly as lm_plan gave
    them with the model inside chip_smoke.py."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    free = 79 << 30
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        mem_get_info=lambda: (free, 80 << 30)))
    assert list(chip_smoke.LM_RUNS) == list(LM_PLAN_AT_79_GIB)
    for arch, (want, reduced) in LM_PLAN_AT_79_GIB.items():
        cfg, got_reduced, pre, dec, seq, need, free_b = \
            chip_smoke.lm_plan(fake, arch)
        assert (cfg.n_layers, pre, dec, seq, need) == want, arch
        assert got_reduced == reduced, arch
        assert free_b == free - chip_smoke.LM_RESERVE


def test_configs_shapes_and_skips_match_reference():
    for arch in jconfigs.ARCH_IDS:
        assert configs.get(arch).SHAPES == jconfigs.get(arch).SHAPES, arch
        assert configs.get(arch).SKIP == jconfigs.get(arch).SKIP, arch


def test_skipped_cell_raises():
    with pytest.raises(ValueError, match="skipped"):
        cells.build_cell("nemotron-4-340b", "long_500k", mesh.ONE_CARD)
