"""stablelm-3b [dense] — MHA (kv = heads). [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    head_dim=80,
    pattern=(LayerSpec(mixer="attn", ff="mlp"),),
    rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b",
))
