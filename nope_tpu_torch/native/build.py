"""Build the native data-plane library (``warp.cpp``, a byte-identical
copy of the JAX package's source) with g++.

Usage: ``python -m nope_tpu_torch.native.build``; the loader of
:mod:`nope_tpu_torch.native` also builds at first use.  The library goes
to ``build/nope_tpu_torch/native/<source hash>/`` at the root of the
checkout, beside the CUDA kernels' build (``ops/_build.py``), never into
the package.  It is compiled for the generic x86-64 (no
``-march=native``), so a library built on one host does not fault on
another that shares the checkout.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "warp.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nope_tpu_torch" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libnope_native.so"


def build(force: bool = False) -> Path:
    """Compile unless this source hash is already built; returns the path."""
    out = library_path()
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libnope_native.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: a concurrent build sees a whole file or none
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
