"""llava-next-mistral-7b [vlm] — Mistral-7B language backbone + anyres vision
frontend stub. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/projector is a stub per the brief: ``input_specs`` supplies
projected patch embeddings (anyres base tile = 576 patches at d_model).
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ff="mlp"),),
    rope_theta=1e6,
    modality="vision",
    modality_tokens=576,  # one anyres base tile; hi-res adds up to 4 more
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
