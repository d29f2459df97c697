"""Synthetic data pipeline (``repro/data`` in numpy)."""
