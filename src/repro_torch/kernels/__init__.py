"""Hand-written Hopper kernels for the serving and training paths.

Every kernel: ``csrc/<name>.cu`` holds the CUDA C++ (built by ``_build.py``
with nvcc for sm_90a, loaded with ctypes), ``<name>.py`` the wrapper that
checks its operands, launches it and counts launches, ``ref.py`` the plain
PyTorch version a CPU tensor runs instead.
"""

from . import ref
from .block_matmul import block_matmul
from .flash_attention import (flash_attention_2d, flash_attention_2d_q,
                              flash_attention_static)
from .moe_experts import moe_experts
from .ops import flash_attention
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_q,
                              paged_verify_attention,
                              paged_verify_attention_q)
from .rmsnorm_matmul import rmsnorm_matmul, rmsnorm_matmul_w8
from .row_norm import layer_norm_rows, rms_norm_rows
from .streamed_ffn import (streamed_ffn, streamed_ffn_w8, streamed_mlp,
                           streamed_mlp_w8)
from .streamed_xent import streamed_xent_loss, streamed_xent_parts

# Every kernel, by the name its launch count goes under: K1-K8, the
# quantized twins K9a-c (int8 / fp8 KV codes) and K10a-c (int8 weights),
# the row-norm helper (LayerNorm and RMSNorm modes), the training loss K11
# and the MoE experts K12.
KERNELS = {
    "rmsnorm_matmul": rmsnorm_matmul,
    "streamed_ffn": streamed_ffn,
    "flash_attention": flash_attention_2d,
    "paged_attention": paged_decode_attention,
    "block_matmul": block_matmul,
    "streamed_mlp": streamed_mlp,
    "flash_attention_static": flash_attention_static,
    "paged_verify_attention": paged_verify_attention,
    "paged_attention_q": paged_decode_attention_q,
    "paged_verify_attention_q": paged_verify_attention_q,
    "flash_attention_q": flash_attention_2d_q,
    "rmsnorm_matmul_w8": rmsnorm_matmul_w8,
    "streamed_ffn_w8": streamed_ffn_w8,
    "streamed_mlp_w8": streamed_mlp_w8,
    "row_norm": layer_norm_rows,
    "streamed_xent": streamed_xent_parts,
    "moe_experts": moe_experts,
    "rms_norm_rows": rms_norm_rows,
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "ref", "block_matmul", "flash_attention", "flash_attention_2d",
    "flash_attention_2d_q", "flash_attention_static", "layer_norm_rows",
    "moe_experts", "rms_norm_rows",
    "paged_decode_attention", "paged_decode_attention_q",
    "paged_verify_attention", "paged_verify_attention_q", "rmsnorm_matmul",
    "rmsnorm_matmul_w8", "streamed_ffn", "streamed_ffn_w8", "streamed_mlp",
    "streamed_mlp_w8", "streamed_xent_loss", "streamed_xent_parts",
    "KERNELS", "reset_launches", "launch_counts",
]
