"""Experiment and architecture configurations, copied from
``repro.configs``: the GGM configs and all ten LM configs (the dense
granite-8b, granite-34b, stablelm-3b and mistral-nemo-12b, the MoE
qwen2-moe-a2.7b, the SSM mamba2-370m, the hybrid jamba-1.5-large-398b,
the vision-prefixed llava-next-mistral-7b and llama4-scout-17b-a16e, and
the encoder-decoder seamless-m4t-large-v2), which register themselves
with ``repro_torch.models.arch``."""
from .ggm_paper import (FIG3, FIG7_STAR, PRODUCTION, SKELETON,  # noqa: F401
                        GGMConfig)
