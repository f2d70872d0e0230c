"""granite-34b [dense] — 88-layer MQA (kv=1) code model. [arXiv:2405.04324]"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ff="mlp"),),
    rope_theta=1e4,
    source="arXiv:2405.04324",
))
