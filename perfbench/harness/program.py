"""The calls into the program under test (``repro_torch``) that every
runner shares: the cell's graph handed to the Experiment API, and the
device helpers."""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from perfbench.data import graph as graph_gen


@dataclasses.dataclass
class Inputs:
    """The benchmark's own inputs, kept on the host for the reference."""
    train_user: np.ndarray
    train_item: np.ndarray
    n_users: int
    n_items: int


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The cell's graph from ``seed``, generated on ``device``; the train
    edges come back to the host, where the program's API takes them."""
    g = graph_gen.generate(config["n_users"], config["n_items"],
                           config["n_edges"], seed,
                           alpha=config["graph"]["alpha"],
                           test_frac=config["graph"]["test_frac"],
                           device=device)
    return Inputs(g.train_user.cpu().numpy(), g.train_item.cpu().numpy(),
                  g.n_users, g.n_items)


def overrides(config: dict, mix: dict, seed: int) -> dict:
    return {**config["overrides"], **mix.get("overrides", {}), "seed": seed}


def build_run(config: dict, mix: dict, seed: int, inputs: Inputs, device):
    """``Experiment.from_preset(preset).override(...).build(train=...)``
    on copies of the inputs (the reference keeps the originals)."""
    from repro_torch.api import Experiment
    from repro_torch.data.synth import InteractionData
    train = InteractionData(inputs.train_user.copy(), inputs.train_item.copy(),
                            inputs.n_users, inputs.n_items)
    exp = Experiment.from_preset(config["preset"]).override(
        overrides(config, mix, seed))
    return exp.build(train=train, holdout=None, device=device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(device) -> None:
    """Release what the program held before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
