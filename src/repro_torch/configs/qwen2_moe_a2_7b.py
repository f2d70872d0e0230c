"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + shared expert.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

d_ff=1408 is the per-expert intermediate; the always-on shared expert has
4x that (4 merged shared experts, intermediate 5632), per the model card.
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ff="moe"),),
    moe_experts=60,
    moe_top_k=4,
    moe_shared_ff=5632,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
