"""Experiment — the user-facing entry point of ``repro_torch.api`` (the
port of ``repro/api/experiment.py``).

    from repro_torch.api import Experiment

    run = Experiment.from_preset("lightgcn-smoke").build()   # on the card
    run.fit()
    print(run.evaluate())
    ids, scores = run.recommend([0, 1, 2])

An Experiment is an immutable wrapper around one ``ExperimentSpec`` with
the constructors (preset / dict / JSON file) and the dotted-path
``override`` hook; ``build()`` materializes it into a live ``Run`` on
``device`` ('cuda' unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Any, Mapping

from repro_torch.api.presets import get_preset
from repro_torch.api.run import Run, build
from repro_torch.api.spec import ExperimentSpec


class Experiment:
    def __init__(self, spec: ExperimentSpec):
        self.spec = spec

    # ------------------------------------------------------- constructors
    @classmethod
    def from_preset(cls, name: str,
                    overrides: Mapping[str, Any] | None = None,
                    **kw: Any) -> "Experiment":
        return cls(get_preset(name).override(overrides, **kw))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Experiment":
        return cls(ExperimentSpec.from_dict(d))

    @classmethod
    def from_file(cls, path: str) -> "Experiment":
        return cls(ExperimentSpec.from_file(path))

    # ------------------------------------------------------- spec surface
    def override(self, overrides: Mapping[str, Any] | None = None,
                 **kw: Any) -> "Experiment":
        return Experiment(self.spec.override(overrides, **kw))

    def to_dict(self) -> dict:
        return self.spec.to_dict()

    def save(self, path: str) -> None:
        self.spec.save(path)

    # ------------------------------------------------------- execution
    def build(self, train=None, holdout=None, device="cuda") -> Run:
        return build(self.spec, train=train, holdout=holdout, device=device)

    def run(self, steps: int | None = None, device="cuda") -> Run:
        """build + fit in one call."""
        r = self.build(device=device)
        r.fit(steps=steps)
        return r

    def __repr__(self) -> str:
        s = self.spec
        return (f"Experiment({s.name!r}, arch={s.model.arch!r}, "
                f"data={s.data.source!r}:{s.data.dataset!r}, "
                f"target_batch={s.plan.target_batch})")
