"""Journal loading for the folds that read a run back.

The JAX module's ``load_records``: every record under one ``.jsonl`` file,
or under every ``*.jsonl`` of a directory. The Perfetto export that the
JAX module also holds (``to_trace_events``, ``export_trace``,
``bench_report``) waits for ROADMAP Queue 1 item 8. Standard library only.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from ..resilience.journal import Journal


def load_records(path) -> List[dict]:
    """All journal records under ``path``: one ``.jsonl`` file, or every
    ``*.jsonl`` in a directory (sorted by name, so a replay is stable)."""
    p = Path(path)
    if p.is_dir():
        records: List[dict] = []
        for f in sorted(p.glob("*.jsonl")):
            records.extend(Journal.load(f))
        return records
    return Journal.load(p)
