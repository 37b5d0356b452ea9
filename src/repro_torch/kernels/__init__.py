"""Hand-written Hopper kernels for the main serving path.

Every kernel: ``csrc/<name>.cu`` holds the CUDA C++ (built by ``_build.py``
with nvcc for sm_90a, loaded with ctypes), ``<name>.py`` the wrapper that
checks its operands, launches it and counts launches, ``ref.py`` the plain
PyTorch version a CPU tensor runs instead.
"""

from . import ref
from .flash_attention import flash_attention_2d
from .ops import flash_attention
from .paged_attention import paged_decode_attention
from .rmsnorm_matmul import rmsnorm_matmul
from .streamed_ffn import streamed_ffn

KERNELS = {
    "rmsnorm_matmul": rmsnorm_matmul,
    "streamed_ffn": streamed_ffn,
    "flash_attention": flash_attention_2d,
    "paged_attention": paged_decode_attention,
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "ref", "flash_attention", "flash_attention_2d", "paged_decode_attention",
    "rmsnorm_matmul", "streamed_ffn", "KERNELS", "reset_launches",
    "launch_counts",
]
