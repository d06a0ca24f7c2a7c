"""Logging configuration (``nope_tpu/utils/logging.py``): the reference's
``src/utils/logging.py`` and its Hydra job_logging presets, without Hydra.
rich and tqdm are imported by the code that uses them."""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable


class LevelsFilter(logging.Filter):
    """Keep only the named levels (used to split INFO/ERROR streams)."""

    def __init__(self, levels: Iterable[str]):
        super().__init__()
        self.levels = [getattr(logging, level) for level in levels]

    def filter(self, record):
        return record.levelno in self.levels


class StreamToLogger:
    """File-like object redirecting writes to a logger."""

    def __init__(self, logger: logging.Logger, level: int):
        self.logger = logger
        self.level = level

    def write(self, buf):
        for line in buf.rstrip().splitlines():
            self.logger.log(self.level, line.rstrip())

    def flush(self):
        pass


class TqdmLoggingHandler(logging.Handler):
    """tqdm-safe log handler."""

    def emit(self, record):
        try:
            import tqdm

            tqdm.tqdm.write(self.format(record))
            self.flush()
        except Exception:  # logging's contract: a failing handler reports through handleError
            self.handleError(record)


def configure(level: int = logging.INFO, log_file: str | None = None) -> None:
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
        handlers=handlers,
        force=True,
    )


_SIMPLE_FMT = logging.Formatter(
    "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    datefmt="%d/%m/%y %H:%M:%S",
)


def configure_preset(
    preset: str = "rich",
    log_dir: str | None = None,
    level: int = logging.INFO,
) -> None:
    """The reference's three Hydra job_logging presets
    (``configs/hydra/job_logging/{console,custom,rich}.yaml``) as plain
    logging config:

    - ``console``: stdout handler only
    - ``custom``/``rich``: stdout + ``logs.out`` (INFO/DEBUG only) +
      ``logs.err`` (WARNING and above only), the split implemented with
      :class:`LevelsFilter` exactly as the presets declare
    - ``rich`` uses ``rich.logging.RichHandler`` for the console when
      the package is importable, else a plain stream handler (colorlog
      and rich are optional upstream too)
    """
    if preset not in ("console", "custom", "rich"):
        raise ValueError(f"unknown job_logging preset {preset!r}")

    console: logging.Handler
    if preset == "rich":
        try:
            from rich.logging import RichHandler

            console = RichHandler(rich_tracebacks=True)
            console.setFormatter(logging.Formatter("%(message)s"))
        except ImportError:
            console = logging.StreamHandler(sys.stdout)
            console.setFormatter(_SIMPLE_FMT)
    else:
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(_SIMPLE_FMT)
    handlers: list[logging.Handler] = [console]

    if preset in ("custom", "rich"):
        base = log_dir or "."
        os.makedirs(base, exist_ok=True)
        file_out = logging.FileHandler(os.path.join(base, "logs.out"))
        file_out.setFormatter(_SIMPLE_FMT)
        file_out.addFilter(LevelsFilter(["INFO", "DEBUG", "NOTSET"]))
        file_err = logging.FileHandler(os.path.join(base, "logs.err"))
        file_err.setFormatter(_SIMPLE_FMT)
        file_err.addFilter(LevelsFilter(["CRITICAL", "ERROR", "WARNING"]))
        handlers += [file_out, file_err]

    logging.basicConfig(level=level, handlers=handlers, force=True)
