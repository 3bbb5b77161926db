"""Logging/observability: colored stdout ticker + per-run file logs.

The port's own copy of the JAX package's ``utils/logging.py``. Mirrors
the reference's user-visible surface (reference train.py:12-14, 167-176,
394-402): a root logger at INFO with timestamps, a per-run
FileHandler under ``{save_dir}/log/``, and the in-place colored progress
ticker with ce_loss / avg_loss / train_acc / avg_acc / exp name.
termcolor isn't a baked-in dependency, so ANSI codes are emitted directly
(and suppressed when stdout isn't a TTY).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_COLORS = {
    "red": "31",
    "green": "32",
    "yellow": "33",
    "blue": "34",
    "magenta": "35",
    "cyan": "36",
}


def colored(text: str, color: str = "green", bold: bool = True) -> str:
    if not sys.stdout.isatty():
        return text
    code = _COLORS.get(color, "32")
    prefix = "1;" if bold else ""
    return f"\x1b[{prefix}{code}m{text}\x1b[0m"


def setup_logging(save_dir: str | None = None, run_name: str = "run") -> logging.Logger:
    """Root INFO logger + optional per-run file handler (train.py:394-402)."""
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if save_dir:
        log_dir = os.path.join(save_dir, "log")
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d_%A_%H:%M:%S")
        fh = logging.FileHandler(
            os.path.join(log_dir, f"{stamp}{run_name}_stdout.log"), "w+"
        )
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


class MetricsWriter:
    """Append-only JSONL metrics stream (``cfg.tpu.metrics_jsonl``).

    One JSON object per line, flushed per record so a preempted or crashed
    run keeps everything written so far. The machine-readable counterpart
    of the stdout ticker: dashboards/regression tooling consume this, the
    ticker stays human-facing. A falsy path makes every call a no-op, so
    call sites don't need to branch.
    """

    def __init__(self, path: str | None):
        self._f = None
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(path, "a")
            self._t0 = time.time()

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def write(self, record_type: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"type": record_type, "wall_s": round(time.time() - self._t0, 3)}
        rec.update(fields)
        json.dump(rec, self._f)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def train_ticker(progress, ce_loss, avg_loss, train_acc, avg_acc, exp_name):
    """In-place colored progress line (reference train.py:167-176)."""
    sys.stdout.write(
        "\rProgress = {p}   ce_loss = {c}   avg_loss = {a}    train_acc = {t}"
        "    avg_acc = {g}    exp: {e}".format(
            p=colored(f"{progress:.3f}", "green"),
            c=colored(f"{ce_loss:.4f}", "blue"),
            a=colored(f"{avg_loss:.4f}", "red"),
            t=colored(f"{train_acc:.4f}", "blue"),
            g=colored(f"{avg_acc:.4f}", "red"),
            e=exp_name,
        )
    )
    sys.stdout.flush()
