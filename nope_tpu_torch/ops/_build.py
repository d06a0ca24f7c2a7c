"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source, all at once, and links the objects into one shared library
with a plain C interface, which :mod:`ctypes` loads.  The build
happens at first use, into ``build/nope_tpu_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources, so an edited source
rebuilds and an unchanged one is reused within a checkout.  Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types; every one returns a
#: cudaError_t as int (0 = success)
SIGNATURES = {
    "nope_reference_similarity": (_P, _P, _P, _P, *[_I] * 7, _P),
    "nope_la_chunks": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "nope_la_merge": (_P, _P, _I, _I, _P),
    "nope_la_output": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "nope_conv_nhwc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "nope_group_stats": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P),
    "nope_gn_silu": (_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P),
    "nope_conv_wgmma": (_P, _P, _P, _I, _P, _P, _P, *[_I] * 10, _P),
    "nope_gn_finalize": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
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
    tag = os.getpid()
    nvcc, log = _nvcc(), []
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out_dir / f"{src.stem}.{tag}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objects = [cmd[-2] for cmd, _ in jobs]
    tmp = out_dir / f"libnope_kernels.{tag}.tmp.so"
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objects]
    try:
        for cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            log.append(" ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{stderr[-4000:]}")
        linked = subprocess.run(link, capture_output=True, text=True, check=False)
        log.append(" ".join(link) + "\n" + linked.stdout + linked.stderr)
        if linked.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({linked.returncode}):\n{linked.stderr[-4000:]}")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for _, job in jobs:  # after a failure the others are stopped
            if job.poll() is None:
                job.kill()
            job.wait()
        for obj in objects:
            Path(obj).unlink(missing_ok=True)
        (out_dir / "build.log").write_text("".join(log))
    os.replace(tmp, lib)  # atomic: a concurrent process sees a whole file or none
    return lib, time.perf_counter() - t0


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


@contextlib.contextmanager
def launcher(device: torch.device):
    """Yield ``call(name, *args)``, which calls one C entry point on
    ``device``'s current stream (passed as the last argument) and raises
    if the launch reports a CUDA error.  The device is made current and
    the stream looked up once for all the calls in the block."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream

        def call(name: str, *args) -> None:
            status = getattr(lib, name)(*args, stream)
            if status != 0:
                raise RuntimeError(f"{name}: CUDA error {status}: {lib.nope_error_string(status).decode()}")

        yield call


def launch(name: str, device: torch.device, *args) -> None:
    """One call through :func:`launcher`."""
    with launcher(device) as call:
        call(name, *args)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (the kernels' tiling plans
    aim to fill them)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda(name: str, t: torch.Tensor, dtypes=(torch.float32, torch.bfloat16)) -> None:
    """Reject what the kernels do not take: another device, dtype, or a
    non-contiguous layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
