"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]

Early fusion: vision patches enter the token stream directly; the vision
encoder is a stub per the brief (input_specs provides projected patch
embeddings). Routed d_ff = 8192 with an always-on shared expert of the same
size, top-1 routing, per the model card.
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ff="moe"),),
    moe_experts=16,
    moe_top_k=1,
    moe_shared_ff=8192,
    rope_theta=5e5,
    modality="vision",
    modality_tokens=144,  # one 12x12 early-fusion image chunk
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
