"""Data plane of the port: the synthetic GGM dataset and its vertical
partition over a mesh."""
from .ggm import GGMDataset, ggm_batches, vertical_sharding  # noqa: F401
