"""Architecture configuration and registry.

A copy of ``repro.models.arch``, with fields of the port's own (NoPE
attention, the attention scale, the muP multipliers, the dropless MoE)
whose defaults leave ``repro``'s architectures as they are: every
architecture is a frozen
``ArchConfig``; configs live in ``repro_torch.configs.<id>`` and register
themselves here. Layer stacks are described as a repeated *superblock* —
a short pattern of sublayers repeated ``n_rep`` times. The port runs every
registered pattern: attention or Mamba2 mixers, cross-attention in the
decoder layers of an encoder-decoder stack, and MLP, MoE or no
feed-forward; a modality frontend is a stub whose embeddings the caller
passes (a decoder prefix for vision, encoder frames for audio).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

MixerKind = Literal["attn", "mamba"]
FFKind = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One sublayer of a superblock: a mixer followed by a feed-forward."""
    mixer: MixerKind = "attn"
    ff: FFKind = "mlp"
    causal: bool = True
    cross_attn: bool = False  # decoder layers of enc-dec models


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    source: str = ""   # citation: paper / model card

    # superblock description; len(pattern) * n_rep == n_layers
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # MoE
    moe_experts: int = 0          # routed experts
    moe_top_k: int = 0
    moe_shared_ff: int = 0        # d_ff of the always-on shared expert(s)
    moe_capacity_factor: float = 1.25
    moe_dropless: bool = False    # every assignment computed, no capacity

    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # attention
    sliding_window: int = 0       # 0 = full attention
    long_context_window: int = 8192  # window applied for the long_500k shape
    rope_theta: float = 1e6
    positional: Literal["rope", "nope"] = "rope"  # "nope": no RoPE
    attention_multiplier: float = 0.0  # the softmax scale; 0 -> 1/sqrt(Dh)

    # encoder-decoder (audio)
    encoder_layers: int = 0
    encoder_pattern: tuple[LayerSpec, ...] = ()

    # modality frontend stub
    modality: Literal["", "vision", "audio"] = ""
    modality_tokens: int = 0      # patch/frame embeddings per sample

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # muP multipliers (Granite 4.0): the embeddings times
    # ``embedding_multiplier``, each sublayer's output times
    # ``residual_multiplier`` before its residual add, the logits over
    # ``logits_scaling``; 1 leaves the path as it is
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}"
        )
        if self.encoder_layers:
            assert self.encoder_pattern, f"{self.name}: encoder needs a pattern"
            assert self.encoder_layers % len(self.encoder_pattern) == 0

    @property
    def n_rep(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the embedding shards on any mesh
        axis (TP=16 x FSDP=16); logits for padding ids are masked to -inf."""
        return -(-self.vocab // 256) * 256

    @property
    def padded_experts(self) -> int:
        """Routed experts rounded to 16 for expert-parallel sharding;
        router logits of padding experts are masked to -inf."""
        return -(-self.moe_experts // 16) * 16 if self.moe_experts else 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        has_attn = any(l.mixer == "attn" for l in self.pattern)
        return not has_attn

    def window_for(self, shape_name: str) -> int:
        """Effective sliding window for an input shape (0 = full)."""
        if shape_name == "long_500k" and not self.attention_free:
            return self.sliding_window or self.long_context_window
        return self.sliding_window

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 superblocks, d_model<=512, <=4 experts."""
        pat_len = len(self.pattern)
        n_layers = pat_len * min(2, self.n_rep)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        enc_layers = 0
        if self.encoder_layers:
            enc_layers = len(self.encoder_pattern) * min(
                2, self.encoder_layers // len(self.encoder_pattern)
            )
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv),
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_shared_ff=min(self.moe_shared_ff, 256),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=64,
            encoder_layers=enc_layers,
            modality_tokens=min(self.modality_tokens, 8),
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    """Import every config module under repro_torch.configs
    (self-registering)."""
    import importlib
    import pkgutil

    import repro_torch.configs as cfgs

    for m in pkgutil.iter_modules(cfgs.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")

