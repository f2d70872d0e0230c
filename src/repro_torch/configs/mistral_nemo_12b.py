"""mistral-nemo-12b [dense] — 128k context. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ff="mlp"),),
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
