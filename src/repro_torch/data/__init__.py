"""Data plane of the port: the synthetic GGM dataset and its vertical
partition over a mesh, and the synthetic LM token stream."""
from .ggm import GGMDataset, ggm_batches, vertical_sharding  # noqa: F401
from .tokens import TokenStream, token_batches  # noqa: F401
