"""Text, JSON and npz helpers (``nope_tpu/utils/inout.py``; the
reference's ``src/utils/inout.py``).  numpy and json only."""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, List

import numpy as np


def write_txt(path: str, lines: Iterable[str]) -> None:
    with open(path, "w") as f:
        for line in lines:
            f.write(str(line) + "\n")


def open_txt(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


def save_json(path: str, obj: Any, indent: int = 4) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, default=_json_default)


def save_npz(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def get_root_project() -> str:
    """The checkout's root: the directory that holds ``nope_tpu_torch/``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
