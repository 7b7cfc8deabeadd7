"""Build and load the port's CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
an object file, all sources at once in parallel, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library's name carries a hash of the sources and flags,
so an edited source is rebuilt at its first use and an unchanged one is
loaded as it is. Build outputs go to ``kernels/build/`` (git-ignored).

Nothing here runs at import: ``library()`` builds on first call, which
only a wrapper handed a CUDA tensor makes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v", "-lineinfo"]

# C entry points: name -> argtypes. "p" is a pointer or the stream
# (c_void_p), "i" an int, "f" a float. Every entry returns cudaError_t.
SIGNATURES: Dict[str, str] = {
    # x, w, y, rows, d, eps, offset, is_bf16, stream
    "rmsnorm_fwd": "pppiiffip",
    # q, k, v, lengths, o, b, h, kvh, s, d, scale, window, is_bf16, stream
    "decode_attention_fwd": "pppppiiiiifiip",
    # q, k, v, o, b, h, kvh, sq, skv, d, scale, causal, window, q_offset, is_bf16, stream
    "flash_attention_fwd": "ppppiiiiiifiiiip",
    # log_a, x, h0, hs, hlast, b, s, d, is_bf16, stream
    "rglru_scan_fwd": "pppppiiiip",
    # r, k, v, lw, u, state0, out, state, b, h, s, k, v, is_bf16, stream
    "wkv6_fwd": "ppppppppiiiiiip",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(KERNEL_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link one library; returns
    its path. A library built from the same sources is reused."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {KERNEL_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest(srcs)
    lib_path = BUILD_DIR / f"libreprotorch_{tag}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    procs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(out)
        if verbose:
            print(f"[nvcc {src.name}]\n{out}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc={proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, sig in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[c] for c in sig]
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel requires of its floating-point operands: CUDA,
    one device, f32 or bf16 alike, contiguous, and no autograd (the
    kernels are forward only)."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA or CPU tensors, got {first.device}")
    if first.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: operands on {first.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if first.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {first.dtype} not in {KERNEL_DTYPES}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: operands of dtype {t.dtype} and {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
        if t.requires_grad:
            raise RuntimeError(f"{name}: the CUDA kernel is forward only; "
                               "call it under torch.no_grad()")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
