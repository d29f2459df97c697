"""AdamW for the port (``repro/optim`` in torch)."""
