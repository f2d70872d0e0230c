"""Hand-written CUDA kernels of the port and their plain versions.

* sign_corr        — int8 Gram G = U^T V (int32 sums, dp4a)
* sign_corr_packed — sign Gram from bit-packed signs, n - 2*popcount(xor)
* code_corr        — Gram of centroid-decoded int8 bin codes
* quantize_fused   — R-bit encode (+ optional decode and dense pack)
* flash_prefill    — full-sequence GQA flash attention (LM prefill)
* decode_attention — one-token GQA flash-decode against a KV cache
* row_normals      — the trial plane's row-keyed threefry normals

Each kernel's plain PyTorch version lives in ``ref``; the wrappers use it
for CPU tensors only. Sources are in ``csrc/`` and build at first use
(``_build``).
"""
from .decode_attention import decode_attention  # noqa: F401
from .flash_prefill import flash_prefill  # noqa: F401
from .quantize import quantize_fused  # noqa: F401
from .row_normals import row_normals  # noqa: F401
from .sign_corr import code_corr, sign_corr, sign_corr_packed  # noqa: F401

#: every kernel wrapper, by name (each carries a ``launches`` count)
WRAPPERS = {
    "sign_corr": sign_corr,
    "sign_corr_packed": sign_corr_packed,
    "code_corr": code_corr,
    "quantize_fused": quantize_fused,
    "flash_prefill": flash_prefill,
    "decode_attention": decode_attention,
    "row_normals": row_normals,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
