"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel module holds its wrapper (launches the CUDA kernel on CUDA
tensors, runs the plain version on CPU tensors), its plain version and a
``LIB`` with the launch counter. Importing builds nothing.
"""

from . import build, decode_attention, flash_attention, softmax, vexp
from .dispatch import dispatch

LIBS = {"vexp": vexp.LIB, "vexp_hw_table": vexp.TABLE_LIB,
        "softmax": softmax.LIB,
        "flash_attention": flash_attention.LIB,
        "decode_attention": decode_attention.LIB,
        "decode_attention_partial": decode_attention.PARTIAL_LIB,
        "decode_attention_packed": decode_attention.PACKED_LIB,
        "decode_attention_paged": decode_attention.PAGED_LIB,
        "decode_attention_paged_partial": decode_attention.PAGED_PARTIAL_LIB,
        "decode_attention_paged_packed": decode_attention.PAGED_PACKED_LIB}


def build_kernels() -> dict:
    """Build every kernel library at once (one nvcc per source)."""
    return build.build_all(sorted({lib.source for lib in LIBS.values()}))


def launch_counts() -> dict:
    return {name: lib.launches for name, lib in LIBS.items()}


def reset_launch_counts() -> None:
    for lib in LIBS.values():
        lib.launches = 0


__all__ = ["dispatch", "build_kernels", "launch_counts",
           "reset_launch_counts", "LIBS"]
