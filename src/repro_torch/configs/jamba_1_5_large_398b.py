"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave with MoE
every other layer. [arXiv:2403.19887]

Superblock of 8 sublayers (the Jamba period): attention at index 4, Mamba
elsewhere; MoE replaces the MLP on odd indices (every other layer, 16
experts top-2). 72 layers = 9 superblocks. Mamba layers use d_state=16 and
expand=2 per the Jamba paper (the assigned spec pins only the MoE/attention
dims); we run them through the Mamba2/SSD layer (DESIGN.md §4).
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

_pattern = tuple(
    LayerSpec(
        mixer="attn" if i == 4 else "mamba",
        ff="moe" if i % 2 == 1 else "mlp",
    )
    for i in range(8)
)

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    pattern=_pattern,
    moe_experts=16,
    moe_top_k=2,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    source="arXiv:2403.19887",
))
