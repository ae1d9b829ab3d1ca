"""Model pieces: LightGCN init and the user-CSR helper."""
