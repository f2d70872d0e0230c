"""Data plane of the port: the synthetic GGM dataset."""
from .ggm import GGMDataset  # noqa: F401
