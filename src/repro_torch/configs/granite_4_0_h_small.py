"""granite-4.0-h-small [hybrid] — Mamba2 mixers beside NoPE GQA attention,
a dropless MoE in every layer, muP multipliers. The port's own config: the
JAX package has no counterpart.
[hf:ibm-granite/granite-4.0-h-small, config.json: granitemoehybrid]

40 layers, a period of 10 (``layer_types``: attention at index 5, Mamba2
elsewhere), so 36 Mamba2 mixers and 4 attention layers. Mamba2: 128 heads
of 64 (d_inner 8192 = expand 2), d_state 128, one group, conv 4 with a
bias, chunk 256, no projection biases. Attention: 32 query and 8 KV heads
of 128, no positional encoding, softmax scale ``attention_multiplier``
1/128. Every layer's feed-forward is a MoE of 72 experts of width 768,
top-10, without capacity (``GraniteMoeParallelExperts`` drops nothing),
plus a shared SwiGLU expert of width 1536. muP: embeddings x 12, each
sublayer's output x 0.22 before its residual add, logits / 16. Tied
embeddings, vocabulary 100,352, RMSNorm eps 1e-5 (the Mamba2 gated norm's
too). ``rope_theta`` is the config's 1e4, unused under NoPE.
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

_pattern = tuple(LayerSpec(mixer="attn" if i == 5 else "mamba", ff="moe")
                 for i in range(10))

CONFIG = register(ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    head_dim=128,
    pattern=_pattern,
    moe_experts=72,
    moe_top_k=10,
    moe_shared_ff=1536,
    moe_dropless=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    rope_theta=1e4,
    positional="nope",
    attention_multiplier=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-4.0-h-small",
))
