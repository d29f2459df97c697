"""Checkpoint store (``repro/checkpoint`` in torch, same on-disk format)."""
