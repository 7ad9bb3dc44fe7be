"""Experiment logging (``selavi_tpu/utils/logger.py``): file logs with an
elapsed-time prefix, and the epoch-stats pickle.

``create_logger`` writes JAX's line layout,
``LEVEL - date time - H:MM:SS - message``, with continuation lines
indented four spaces. ``PDStats`` keeps the JAX class's contract (same
path, appended on resume, the column schema checked) without pandas, which
the card machine lacks: the pickle holds a plain
``{"columns": [...], "rows": [[...], ...]}``, not a DataFrame.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from pathlib import Path

_FMT = "%(levelname)s - %(asctime)s - %(elapsed)s - %(message)s"
_DATEFMT = "%x %X"
_CONTINUATION_INDENT = "\n    "


class _ElapsedFilter(logging.Filter):
    """Attaches ``record.elapsed`` = wall time since logger creation, as
    H:MM:SS."""

    def __init__(self, t0: float):
        super().__init__()
        self.t0 = t0

    def filter(self, record: logging.LogRecord) -> bool:
        dt = max(int(record.created - self.t0), 0)
        record.elapsed = "{}:{:02d}:{:02d}".format(
            dt // 3600, dt % 3600 // 60, dt % 60
        )
        return True


class _IndentingFormatter(logging.Formatter):
    """Indents continuation lines of multi-line messages so log files stay
    line-greppable (one prefixed line per record head)."""

    def format(self, record: logging.LogRecord) -> str:
        out = super().format(record)
        if "\n" in out:
            head, _, rest = out.partition("\n")
            out = head + _CONTINUATION_INDENT + rest.replace(
                "\n", _CONTINUATION_INDENT
            )
        return out


def create_logger(filepath: str | None, rank: int = 0) -> logging.Logger:
    """Rank 0 writes ``train.log``; every other rank ``train.log-{rank}``;
    the console shows INFO on rank 0 only."""
    log = logging.getLogger()
    log.handlers.clear()
    log.setLevel(logging.DEBUG)

    t0 = time.time()
    elapsed = _ElapsedFilter(t0)
    formatter = _IndentingFormatter(_FMT, datefmt=_DATEFMT)

    handlers: list[logging.Handler] = []
    if filepath is not None:
        target = f"{filepath}-{rank}" if rank > 0 else filepath
        Path(target).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(target, "a")
        fh.setLevel(logging.DEBUG)
        handlers.append(fh)
    if rank == 0:
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        handlers.append(ch)
    for h in handlers:
        h.addFilter(elapsed)
        h.setFormatter(formatter)
        log.addHandler(h)

    log.reset_time = t0  # type: ignore[attr-defined]
    return log


class PDStats:
    """Epoch-level stats rows, pickled after each update, with a
    column-schema check on resume."""

    def __init__(self, path: str, columns):
        self.path = path
        self.columns = list(columns)
        self.rows: list[list] = []
        if os.path.isfile(path):
            with open(path, "rb") as f:
                saved = pickle.load(f)
            if saved["columns"] != self.columns:
                raise ValueError(
                    f"stats file {path} has columns {saved['columns']}, "
                    f"expected {self.columns}"
                )
            self.rows = saved["rows"]

    def update(self, row, save: bool = True):
        self.rows.append(list(row))
        if save:
            with open(self.path, "wb") as f:
                pickle.dump({"columns": self.columns, "rows": self.rows}, f)
