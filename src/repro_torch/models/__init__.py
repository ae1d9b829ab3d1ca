"""Model pool beyond the paper's own two models (the port of
``repro/models``): GCN (``gcn``) and the CTR and sequential
recommenders (``recsys_models``).  The LM pool (``attention``, ``moe``,
``transformer``) is not ported yet (ROADMAP A12b)."""
