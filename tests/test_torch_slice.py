"""The serving slice as a whole, and the port's isolation from JAX.

The reference builds ``lightgcn-smoke`` through its Experiment API and
answers ``run.recommend`` at the init state; the port rebuilds the same
data with its own ``synth``, takes the same params through
``params_from_jax``, and must give the same ids and scores."""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro.api import Experiment
from repro_torch.convert import params_from_jax
from repro_torch.data import synth
from repro_torch.eval import Recommender
from repro_torch.pipeline import BipartiteCSR, get_model
from repro_torch.serving import ManualClock, RecommenderService


def _port_recommender(run):
    spec = run.spec
    data = synth.generate_bipartite(spec.data.n_users, spec.data.n_items,
                                    spec.data.edges, seed=spec.data.seed)
    train, _ = synth.train_test_split(data, spec.data.test_frac,
                                      seed=spec.data.seed)
    np.testing.assert_array_equal(train.user, run.train_data.user)
    np.testing.assert_array_equal(train.item, run.train_data.item)
    g = BipartiteCSR(train.user, train.item, train.n_users, train.n_items,
                     device="cpu")
    params = params_from_jax({k: np.array(v) for k, v in run.params.items()},
                             device="cpu")
    with torch.inference_mode():
        user_e, item_e = get_model("lightgcn").forward(params, g,
                                                       spec.model.n_layers)
    indptr, items = g.seen_csr()
    return Recommender(user_e, item_e, seen_indptr=indptr, seen_items=items,
                       k=spec.eval.k, item_block=spec.eval.item_block,
                       device="cpu")


def test_lightgcn_smoke_serving_slice_matches_reference():
    run = Experiment.from_preset("lightgcn-smoke").build()
    users = np.arange(run.train_data.n_users)
    want_ids, want_scores = run.recommend(users)
    rec = _port_recommender(run)
    ids, scores = rec.recommend(users)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-6)
    # and through the queue-fronted service, request by request
    svc = RecommenderService(rec, max_batch=8, max_wait_us=100,
                             clock=ManualClock())
    order = [5, 0, 63, 5, 17, 40, 2, 9, 33, 12]
    for uid in order:
        svc.submit(uid)
    for r in svc.drain():
        np.testing.assert_array_equal(r.ids, want_ids[r.user_id])
        np.testing.assert_allclose(r.scores, want_scores[r.user_id],
                                   rtol=1e-5, atol=1e-6)


def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch imports in a fresh interpreter without
    pulling in jax or any module of the reference package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        print(len(names))
    """)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=False, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
