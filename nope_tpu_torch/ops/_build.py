"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package into one shared
library with a plain C interface, which :mod:`ctypes` loads.  The build
happens at first use, into ``build/nope_tpu_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources, so an edited source
rebuilds and an unchanged one is reused within a checkout.  Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nope_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types; every one returns a
#: cudaError_t as int (0 = success)
SIGNATURES = {
    "nope_reference_similarity": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "nope_linear_attention": (_P, _P, _I, _I, _I, _F, _I, _P),
    "nope_conv_nhwc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "nope_group_stats": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    "nope_gn_silu": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_library: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> tuple[Path, float]:
    """Compile the library unless this source hash is already built.
    Returns its path and the seconds the build took (0.0 when reused);
    ``nvcc``'s output, with ``-Xptxas -v``'s register and shared-memory
    report, is kept as ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libnope_kernels.so"
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libnope_kernels.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent process sees a whole file or none
    return lib, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    if _library is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nope_error_string.argtypes = (ctypes.c_int,)
        lib.nope_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry point with ``device`` current, on its current
    stream (passed as the last argument); raise if the launch reports a
    CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        status = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}: {lib.nope_error_string(status).decode()}")


def check_cuda(name: str, t: torch.Tensor, dtypes=(torch.float32, torch.bfloat16)) -> None:
    """Reject what the kernels do not take: another device, dtype, or a
    non-contiguous layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
