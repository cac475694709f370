"""Run ledgers: success/failure accounting and shard/resume semantics.

A copy of `anyedit_tpu/core/ledger.py` (which cannot be imported without
JAX: its package `__init__` imports the mesh). The same `mark`s write the
same JSONL bytes.

  * every processed record is appended as one line {key, status, record,
    payload}, flushed and fsynced;
  * a restart replays the ledger and skips keys already done (a torn final
    line from a crash is ignored);
  * shard bounds are explicit (`Shard`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Iterator, Sequence

from anyedit_tpu_torch.core.schema import InstructionRecord


@dataclasses.dataclass(frozen=True)
class Shard:
    """Static [start, end) shard of a record stream (replaces --start-idx/--end-idx)."""

    index: int = 0
    count: int = 1
    start: int | None = None
    end: int | None = None

    def slice(self, n: int) -> range:
        if self.start is not None or self.end is not None:
            s = 0 if self.start is None else self.start
            e = n if self.end is None else min(self.end, n)
            return range(s, e)
        # balanced contiguous split
        base, rem = divmod(n, self.count)
        sizes = [base + (1 if i < rem else 0) for i in range(self.count)]
        s = sum(sizes[: self.index])
        return range(s, s + sizes[self.index])


def _read_lines(path: Path) -> Iterator[dict[str, Any]]:
    """The ledger's objects; a torn final line from a crash is skipped."""
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            continue


class RunLedger:
    """Append-only JSONL ledger with idempotent-resume semantics."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._done: dict[str, str] = {}
        self._payloads: dict[str, dict[str, Any]] = {}
        if self.path.exists():
            for obj in _read_lines(self.path):
                self._done[obj["key"]] = obj["status"]
                self._payloads[obj["key"]] = obj.get("payload", {})
        self._f = self.path.open("a")

    # ---- write ----------------------------------------------------------
    def mark(self, record: InstructionRecord, status: str,
             payload: dict[str, Any] | None = None) -> None:
        assert status in ("success", "failure", "filtered")
        key = record.key()
        obj = {"key": key, "status": status, "record": record.to_json(),
               "payload": payload or {}}
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._done[key] = status
        self._payloads[key] = payload or {}

    # ---- read -----------------------------------------------------------
    def is_done(self, record: InstructionRecord) -> bool:
        return record.key() in self._done

    def status(self, record: InstructionRecord) -> str | None:
        return self._done.get(record.key())

    def pending(self, records: Sequence[InstructionRecord],
                shard: Shard | None = None) -> Iterator[tuple[int, InstructionRecord]]:
        """Yield (index, record) for this shard's not-yet-processed records."""
        for i in (shard or Shard()).slice(len(records)):
            if not self.is_done(records[i]):
                yield i, records[i]

    def counts(self) -> dict[str, int]:
        out = {"success": 0, "failure": 0, "filtered": 0}
        for s in self._done.values():
            out[s] = out.get(s, 0) + 1
        return out

    # ---- export (reference-compatible result files) ---------------------
    def export_reference_files(self, out_dir: str | Path, start: int = 0,
                               end: int | None = None) -> None:
        """Write final_edit_results/_success/_failure JSON like the reference."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        succ, fail = [], []
        for obj in _read_lines(self.path):
            (succ if obj["status"] == "success" else fail).append(obj["record"])
        tag = f"{start}_{end if end is not None else len(succ) + len(fail)}"
        (out_dir / f"final_edit_results_{tag}.json").write_text(json.dumps(succ, indent=1))
        (out_dir / f"edit_success_{tag}.json").write_text(json.dumps(succ, indent=1))
        (out_dir / f"edit_failure_{tag}.json").write_text(json.dumps(fail, indent=1))

    def close(self) -> None:
        self._f.close()
