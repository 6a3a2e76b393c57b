"""Synthetic data pipeline of the port (``repro/data``)."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM  # noqa: F401
