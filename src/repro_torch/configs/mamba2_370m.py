"""mamba2-370m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]

48 Mamba2 layers, d_state=128, expand=2 (d_inner=2048), head_dim=64
(32 SSD heads). No feed-forward sublayer (Mamba2 blocks are the whole
layer), no attention — long_500k decode runs on the constant-size SSM
state.
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    pattern=(LayerSpec(mixer="mamba", ff="none"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    source="arXiv:2405.21060",
))
