"""Hand-written CUDA kernels for the perf-critical compute of the models.

Each kernel directory contains:
  * ``csrc/*.cu`` — the CUDA C++ kernel for ``sm_90a`` with a plain C
    entry point, built by ``_build.py`` and loaded with ``ctypes``;
  * ``ops.py``    — the public wrapper: the plain version for a CPU
    tensor, the kernel (or an error) for a CUDA tensor, and a count of
    kernel launches;
  * ``ref.py``    — the plain PyTorch version of the same function.
"""

from typing import Dict

from .decode_attention import ops as _decode_ops
from .flash_attention import ops as _flash_ops
from .rglru_scan import ops as _rglru_ops
from .rmsnorm import ops as _rmsnorm_ops
from .wkv6 import ops as _wkv6_ops
from .decode_attention.ops import decode_attention
from .flash_attention.ops import flash_attention
from .rglru_scan.ops import rglru_scan
from .rmsnorm.ops import rmsnorm
from .wkv6.ops import wkv6

_OPS = {"rmsnorm": _rmsnorm_ops, "decode_attention": _decode_ops,
        "flash_attention": _flash_ops, "rglru_scan": _rglru_ops, "wkv6": _wkv6_ops}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _OPS.items()}


def reset_launch_counts() -> None:
    for mod in _OPS.values():
        mod.launches = 0


__all__ = ["flash_attention", "decode_attention", "rglru_scan", "rmsnorm", "wkv6",
           "launch_counts", "reset_launch_counts"]
