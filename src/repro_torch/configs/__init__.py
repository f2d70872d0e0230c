"""Experiment and architecture configurations, copied from
``repro.configs``: the GGM configs and the four dense LM configs
(granite-8b, granite-34b, stablelm-3b, mistral-nemo-12b), which register
themselves with ``repro_torch.models.arch``."""
from .ggm_paper import FIG3, PRODUCTION, GGMConfig  # noqa: F401
