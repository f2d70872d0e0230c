"""Experiment and architecture configurations: the GGM configs and the
ten LM configs copied from ``repro.configs`` (the dense
granite-8b, granite-34b, stablelm-3b and mistral-nemo-12b, the MoE
qwen2-moe-a2.7b, the SSM mamba2-370m, the hybrid jamba-1.5-large-398b,
the vision-prefixed llava-next-mistral-7b and llama4-scout-17b-a16e, and
the encoder-decoder seamless-m4t-large-v2), and the port's own
granite-4.0-h-small (Mamba2 beside NoPE attention, a dropless MoE, muP
multipliers), which register themselves with ``repro_torch.models.arch``."""
from .ggm_paper import (FIG3, FIG7_STAR, PRODUCTION, SKELETON,  # noqa: F401
                        GGMConfig)
