"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596]

The speech frontend (mel-spectrogram + conformer feature extractor) is a
stub per the brief: ``input_specs`` provides frame embeddings at d_model for
the encoder. Encoder = 24 bidirectional layers; decoder = 24 causal layers
with cross-attention. For long_500k the decoder self-attention runs with the
long-context sliding window and cross-attends to a fixed-length encoder
memory (DESIGN.md §4).
"""
from repro_torch.models.arch import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    pattern=(LayerSpec(mixer="attn", ff="mlp", cross_attn=True),),
    encoder_layers=24,
    encoder_pattern=(LayerSpec(mixer="attn", ff="mlp", causal=False),),
    rope_theta=1e4,
    modality="audio",
    modality_tokens=0,  # frames go to the encoder, not the decoder prefix
    source="arXiv:2308.11596",
))
