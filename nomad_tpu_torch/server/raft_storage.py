"""Durable raft state: log, term/vote metadata, FSM snapshots.

Reference: the reference persists its raft log in BoltDB (raft.db via
raft-boltdb) and FSM snapshots as retained files (fsm.go:506-1036,
snapshotsRetained=2 at server.go:50), restoring snapshot + log replay
on restart. Here: an append-only JSONL log (rewritten on the rare
conflict truncation/compaction), a small meta JSON for term/voted_for
(flushed before votes are answered — the raft safety requirement), and
numbered snapshot files with retention.

The port of the JAX package's server/raft_storage.py: the same files,
byte for byte, so either package loads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional, Tuple

SNAPSHOTS_RETAINED = 2


class RaftStorage:
    def __init__(self, directory: str,
                 encode: Optional[Callable[[str, Any], Any]] = None,
                 decode: Optional[Callable[[str, Any], Any]] = None,
                 retained: int = SNAPSHOTS_RETAINED):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.encode = encode or (lambda mt, p: p)
        self.decode = decode or (lambda mt, p: p)
        self.retained = retained
        self._log_path = os.path.join(directory, "raft_log.jsonl")
        self._meta_path = os.path.join(directory, "raft_meta.json")
        self._log_file = None

    # ------------------------------------------------------------ meta

    def save_meta(self, term: int, voted_for: Optional[str]) -> None:
        """Durable BEFORE answering votes: a restarted node must not
        vote twice in one term."""
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": term, "voted_for": voted_for}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    def load_meta(self) -> Tuple[int, Optional[str]]:
        try:
            with open(self._meta_path) as f:
                data = json.load(f)
            return int(data.get("term", 0)), data.get("voted_for")
        except (OSError, ValueError):
            return 0, None

    # ------------------------------------------------------------- log

    def _entry_to_wire(self, entry) -> dict:
        return {
            "term": entry.term,
            "index": entry.index,
            "msg_type": entry.msg_type,
            "payload": self.encode(entry.msg_type, entry.payload),
        }

    def append_entry(self, entry) -> None:
        if self._log_file is None:
            self._log_file = open(self._log_path, "a")
        self._log_file.write(json.dumps(self._entry_to_wire(entry)) + "\n")
        self._log_file.flush()
        # Same safety bar as save_meta: an entry counted as durably
        # replicated must survive power loss before the commit is acked.
        os.fsync(self._log_file.fileno())

    def rewrite_log(self, entries: List[Any]) -> None:
        """Full rewrite after a conflict truncation or compaction."""
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
        tmp = self._log_path + ".tmp"
        with open(tmp, "w") as f:
            for entry in entries:
                f.write(json.dumps(self._entry_to_wire(entry)) + "\n")
        os.replace(tmp, self._log_path)

    def load_log(self, entry_cls) -> List[Any]:
        entries = []
        try:
            with open(self._log_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        raw = json.loads(line)
                    except ValueError:
                        break  # torn tail write: ignore the partial line
                    entries.append(entry_cls(
                        term=raw["term"], index=raw["index"],
                        msg_type=raw["msg_type"],
                        payload=self.decode(raw["msg_type"], raw["payload"]),
                    ))
        except OSError:
            pass
        return entries

    # ------------------------------------------------------- snapshots

    def _snapshot_path(self, index: int) -> str:
        return os.path.join(self.dir, f"snapshot-{index:020d}.json")

    def save_snapshot(self, index: int, term: int, data: dict) -> None:
        tmp = self._snapshot_path(index) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"index": index, "term": term, "data": data}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path(index))
        # retention (server.go:50 snapshotsRetained)
        snaps = sorted(
            n for n in os.listdir(self.dir)
            if n.startswith("snapshot-") and n.endswith(".json")
        )
        for name in snaps[: -self.retained]:
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    def load_latest_snapshot(self) -> Optional[Tuple[int, int, dict]]:
        snaps = sorted(
            (n for n in os.listdir(self.dir)
             if n.startswith("snapshot-") and n.endswith(".json")),
            reverse=True,
        )
        for name in snaps:
            try:
                with open(os.path.join(self.dir, name)) as f:
                    raw = json.load(f)
                return int(raw["index"]), int(raw["term"]), raw["data"]
            except (OSError, ValueError, KeyError):
                continue  # corrupt snapshot: fall back to the previous
        return None

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
