"""Crash-consistent journal and atomic artifact writes.

The JAX package's ``resilience/journal.py``, copied (the port imports
nothing of that package):

- **Atomic writes** (``atomic_write_text``/``atomic_write_bytes``/
  ``atomic_open``/``atomic_writer``): a tmp file in the target's directory,
  flush + fsync, ``os.replace`` (atomic on POSIX), then a best-effort
  directory fsync. Readers see the old complete file or the new complete
  file, never a torn one. The tuner's plan file is written this way.
- **Journal**: an append-only jsonl log, one JSON object per line, each
  append flushed and fsync'd before the caller goes on. A crash can lose at
  most the final partial line, which ``Journal.load`` skips. Records carry
  a ``kind`` and a caller ``key``; the tolerance gate journals its
  ``gate_pass``/``gate_fail`` verdicts here.

Standard library only.
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path
from typing import IO, Dict, Iterator, List, Optional

JOURNAL_NAME = "journal.jsonl"


def _fsync_dir(directory: Path) -> None:
    """Best-effort fsync of a directory so a completed rename is durable."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_open(path: str | Path, mode: str = "w", **kw) -> Iterator[IO]:
    """Open a tmp file next to ``path`` for writing; on clean exit fsync it
    and ``os.replace`` it over ``path``. On an exception the tmp file is
    removed and ``path`` is untouched — the crash-consistency contract every
    run artifact (checkpoint npz, CSV, committed JSON) writes under."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp.{os.getpid()}"
    fh = open(tmp, mode, **kw)
    try:
        yield fh
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    except BaseException:
        fh.close()
        with contextlib.suppress(OSError):
            tmp.unlink()
        raise


# csv.writer and friends want this exact signature; alias keeps call sites
# self-documenting about WHY they are not using open(..., "w").
atomic_writer = atomic_open


def atomic_write_text(path: str | Path, text: str) -> Path:
    path = Path(path)
    with atomic_open(path, "w") as fh:
        fh.write(text)
    return path


def atomic_write_bytes(path: str | Path, data: bytes) -> Path:
    path = Path(path)
    with atomic_open(path, "wb") as fh:
        fh.write(data)
    return path


class Journal:
    """Append-only jsonl journal with fsync'd appends.

    ``append(kind, key=..., **payload)`` durably records one event and
    returns the record. ``load(path)`` replays a journal, skipping a torn
    final line (the only damage a kill mid-append can do). ``completed``
    collapses replayed records of one kind into a ``{key: record}`` map
    (later records win), the idempotent-resume primitive.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh: Optional[IO] = None

    def append(self, kind: str, key: str = "", **payload) -> dict:
        rec = {"kind": kind, "key": key, **payload}
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def load(path: str | Path) -> List[dict]:
        """Replay a journal file; missing file -> []. A torn/corrupt line is
        skipped (crash mid-append), never an exception."""
        path = Path(path)
        if not path.exists():
            return []
        records: List[dict] = []
        with open(path, errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail from a kill mid-append
                if isinstance(rec, dict):
                    records.append(rec)
        return records

    @staticmethod
    def completed(records: List[dict], kind: str) -> Dict[str, dict]:
        """{key: record} for records of ``kind`` with a key; later wins."""
        out: Dict[str, dict] = {}
        for rec in records:
            if rec.get("kind") == kind and rec.get("key"):
                out[str(rec["key"])] = rec
        return out
