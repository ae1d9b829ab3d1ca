"""Model pool beyond the paper's own two models (the port of
``repro/models``): GCN (``gcn``), the CTR and sequential recommenders
(``recsys_models``) and the LM pool (``attention``, ``moe``,
``transformer``)."""
