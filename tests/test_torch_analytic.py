"""The port's LM cost model (``repro_torch.launch.analytic``) against
``repro.launch.analytic``: FLOPs, HBM bytes and collective bytes equal as
floats for the five FULL configs x the three kinds (train, prefill,
decode) at each config's own cell shapes, on one card (``ONE_CARD``), the
production 16 x 16 mesh and the two-pod mesh; and the port's ``dp_size``.
The meshes are stand-ins with the axis names and sizes a JAX mesh has."""
import types

import pytest

from repro import configs as jconfigs
from repro.launch import analytic as janalytic
from repro_torch import configs
from repro_torch.launch import analytic

LM_ARCHS = ["nemotron_4_340b", "gemma2_2b", "granite_3_8b", "mixtral_8x7b",
            "kimi_k2_1t_a32b"]
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
MESHES = {"one_card": {"data": 1, "model": 1},
          "pod": {"data": 16, "model": 16},
          "two_pods": {"pod": 2, "data": 16, "model": 16}}


def mesh(shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", list(KIND_SHAPE))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_cost_matches_reference(arch, kind, mesh_name):
    shape = configs.get(arch).SHAPES[KIND_SHAPE[kind]]
    m = mesh(MESHES[mesh_name])
    got = analytic.lm_cost(kind, configs.get(arch).FULL, shape, m)
    want = janalytic.lm_cost(kind, jconfigs.get(arch).FULL, shape, m)
    assert got == want
    assert all(isinstance(v, float) for v in got.values())


def test_long_context_shapes_match_reference():
    for arch in ("gemma2_2b", "mixtral_8x7b"):
        shape = configs.get(arch).SHAPES["long_500k"]
        m = mesh(MESHES["one_card"])
        assert analytic.lm_decode_cost(configs.get(arch).FULL, shape, m) == \
            janalytic.lm_decode_cost(jconfigs.get(arch).FULL, shape, m)


def test_dp_size_and_one_card():
    assert analytic.dp_size(analytic.ONE_CARD) == 1
    assert analytic.dp_size(mesh(MESHES["pod"])) == 16
    assert analytic.dp_size(mesh(MESHES["two_pods"])) == 32
    assert analytic.ONE_CARD.shape == {"data": 1, "model": 1}
