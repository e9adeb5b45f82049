"""Structured JSONL metrics logging (``svax/train/metrics.py``).

The canonical sink is line-delimited JSON, one dict per chunk or
evaluation, which plotting and benchmark scripts read directly.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import IO, Any


class JsonlLogger:
    """Append-only JSONL metrics writer with wall-clock stamping.

    Each row is ``{"step", "wall_s", **values}``: echoed to stdout (unless
    ``echo=False``), appended to ``path`` and flushed. Optionally mirrors
    the float values to TensorBoard (``tensorboard_dir``) through
    ``torch.utils.tensorboard`` when that imports; JSONL stays canonical.
    """

    def __init__(
        self,
        path: str | Path | None = None,
        echo: bool = True,
        tensorboard_dir: str | Path | None = None,
    ):
        self._fh: IO[str] | None = None
        if path:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(p, "a")
        self._echo = echo
        self._t0 = time.perf_counter()
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(tensorboard_dir))
            except Exception:  # TensorBoard is optional; JSONL is canonical
                self._tb = None

    def log(self, step: int, **values: Any) -> dict:
        row = {"step": int(step), "wall_s": round(time.perf_counter() - self._t0, 3)}
        for k, v in values.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        line = json.dumps(row)
        if self._echo:
            print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "wall_s") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
        return row

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str | Path) -> list[dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
