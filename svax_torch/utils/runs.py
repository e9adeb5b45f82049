"""Where the port's study entries write their JSON artifacts.

``runs/`` holds the reference's own artifacts (seed sweeps, probes,
quality tables), which the port's entries never overwrite: they write
files whose names carry ``torch``, and ``port_artifact`` refuses any other
path in that directory.
"""

from __future__ import annotations

from pathlib import Path

RUNS = Path(__file__).resolve().parent.parent.parent / "runs"


def port_artifact(path: str | Path) -> Path:
    """``path`` as a Path; raises ValueError for a file in the repo's
    ``runs/`` whose name lacks ``torch`` (a reference artifact)."""
    path = Path(path)
    if path.resolve().parent == RUNS and "torch" not in path.name:
        raise ValueError(f"{path}: runs/ holds the reference's artifacts; the port "
                         "writes files named *torch*")
    return path


def write_json(path: str | Path, payload) -> Path:
    """Write ``payload`` as indented JSON to ``port_artifact(path)``."""
    import json

    path = port_artifact(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1))
    return path
