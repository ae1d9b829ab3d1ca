"""repro_torch.api — the unified Experiment API (the port of
``repro.api``).

One declarative ``ExperimentSpec`` (model / data / plan / loop / eval)
drives the whole stack: ``build(spec, device=...)`` returns a ``Run``
exposing ``fit()`` (fault-tolerant loop), ``evaluate()`` (streaming
top-K), ``recommend()`` (serving facade), and ``resume()``.

  Experiment  — preset / dict / JSON-file constructors + overrides;
  ExperimentSpec, ModelCfg, DataCfg, PlanCfg, MeshCfg, MemoryCfg,
      CompressionCfg, LoopCfg, EvalCfg, ServeCfg — the typed,
      serializable sections (the reference's, key for key);
  build / Run — spec -> live handle;
  get_preset / register_preset / preset_names — the preset registry;
  load_data / register_data_source — data sources behind one protocol.
"""
from repro_torch.api.data import (DATA_SOURCES, load_data,
                                  register_data_source)
from repro_torch.api.experiment import Experiment
from repro_torch.api.presets import get_preset, preset_names, register_preset
from repro_torch.api.run import Run, build
from repro_torch.api.spec import (CompressionCfg, DataCfg, EvalCfg,
                                  ExperimentSpec, LoopCfg, MemoryCfg, MeshCfg,
                                  ModelCfg, PlanCfg, ServeCfg)

__all__ = [
    "Experiment", "ExperimentSpec", "ModelCfg", "DataCfg", "PlanCfg",
    "MeshCfg", "MemoryCfg", "CompressionCfg", "LoopCfg", "EvalCfg",
    "ServeCfg", "Run", "build",
    "get_preset", "register_preset", "preset_names", "load_data",
    "register_data_source", "DATA_SOURCES",
]
