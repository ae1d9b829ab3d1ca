"""Preset registry — named ExperimentSpecs (the port of
``repro/api/presets.py``, the same names and specs).

Absorbs the ``configs`` module-per-arch FULL/SMOKE entries for the
GNNRecSys family, so ``Experiment.from_preset("lightgcn-smoke")``
resolves to the same shapes ``configs.get("lightgcn").SMOKE`` declares
(the registry reads the config modules at import, it cannot drift).  The
``*-full`` presets leave ``plan.microbatch`` to the planner (None), which
the port does not have yet (ROADMAP A5): building one raises unless the
microbatch is overridden.  ``register_preset`` adds
project-local presets; a preset is stored as a zero-arg factory so
registration order never freezes a stale spec.
"""
from __future__ import annotations

from typing import Callable

from repro_torch import configs as _configs
from repro_torch.api.spec import (DataCfg, EvalCfg, ExperimentSpec, LoopCfg,
                            ModelCfg, PlanCfg)

_PRESETS: dict[str, Callable[[], ExperimentSpec]] = {}


def register_preset(name: str,
                    factory: Callable[[], ExperimentSpec]) -> None:
    _PRESETS[name] = factory


def preset_names() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> ExperimentSpec:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {preset_names()}")
    return _PRESETS[name]()


# ------------------------------------------------- configs absorption
def _spec_from_config(arch: str, cfg, optimizer: str,
                      smoke: bool) -> ExperimentSpec:
    """One config-registry entry -> a runnable spec.  FULL keeps the
    paper's §7.1 schedule (1K warm-up toward the 150K target); SMOKE is
    a no-warm-up micro run sized for CPU tests."""
    return ExperimentSpec(
        name=cfg.name,
        model=ModelCfg(arch=arch, embed_dim=cfg.embed_dim,
                       n_layers=cfg.n_layers),
        data=DataCfg(source="bipartite", n_users=cfg.n_users,
                     n_items=cfg.n_items, edges=cfg.n_edges),
        plan=PlanCfg(target_batch=cfg.bpr_batch,
                     base_batch=cfg.bpr_batch if smoke else 1024,
                     microbatch=cfg.bpr_batch if smoke else None,
                     warmup_epochs=0 if smoke else 2),
        loop=LoopCfg(steps=20 if smoke else 1000),
        eval=EvalCfg(k=20),
        optimizer=optimizer,
    )


def _register_config_presets() -> None:
    for arch_id in _configs.ARCH_IDS:
        mod = _configs.get(arch_id)
        if getattr(mod, "FAMILY", None) != "gnnrecsys":
            continue
        for variant, smoke in (("full", False), ("smoke", True)):
            cfg = getattr(mod, variant.upper())
            register_preset(
                f"{arch_id}-{variant}",
                lambda a=arch_id, c=cfg, o=mod.OPTIMIZER, s=smoke:
                    _spec_from_config(a, c, o, s))


_register_config_presets()


# ------------------------------------------------- project presets
def _quickstart() -> ExperimentSpec:
    """The README/examples run: paper recipe (warm-up batch + linear LR
    scaling, plain SGD) on a movielens-statistics graph, CPU-sized."""
    return ExperimentSpec(
        name="quickstart",
        model=ModelCfg(arch="lightgcn", embed_dim=32, n_layers=2),
        data=DataCfg(source="synth", dataset="movielens-10m", edges=8000),
        plan=PlanCfg(target_batch=1024, base_batch=64, microbatch=256,
                     warmup_epochs=2, lr_scaling="linear"),
        loop=LoopCfg(steps=120),
        eval=EvalCfg(k=20),
        optimizer="sgd", base_lr=0.02,
    )


register_preset("quickstart", _quickstart)
