"""Experiment configurations (copies of ``repro.configs``' GGM configs)."""
from .ggm_paper import FIG3, PRODUCTION, GGMConfig  # noqa: F401
