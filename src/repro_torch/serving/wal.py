"""Mutation write-ahead log + durable index wrapper.

Counterpart of ``repro.serving.wal``; the log's bytes are the
reference's, so either package replays the other's log and opens the
other's durability directory.  Every ``submit_add``/``submit_delete``
the engine acknowledges lives only in process memory (and on the
card) until someone saves, so a crash would lose acknowledged work.
This module closes the gap with the classic recipe:

* :class:`WriteAheadLog` — checksummed append-only record log.  The
  engine appends every mutation batch *before* its tickets resolve,
  so an acknowledged mutation is always reconstructible.
* :class:`DurableIndex` — an :class:`~repro_torch.index.api.AshIndex` plus
  its log directory: atomic checkpoints (``ckpt-<seqno>`` dirs written
  via the index's crash-safe
  :meth:`~repro_torch.index.api.AshIndex.save`),
  and :meth:`DurableIndex.open` recovery — newest valid checkpoint,
  torn WAL tail truncated, surviving records replayed idempotently
  past the checkpoint's high-water mark.

Record framing (little-endian)::

    magic 'AWAL' | kind u8 | seqno u64 | payload_len u32 | crc32 u32
    | payload

The crc covers kind+seqno+len+payload, so a flipped bit anywhere in a
record is detected; a short read at the tail is a *torn* record.  Both
end replay at the last intact prefix — which is exactly the durable
set.  Seqnos are assigned contiguously from 1; a checkpoint's manifest
stores the last seqno it contains (``wal_seqno``), and replay skips
records at or below it, making recovery idempotent.

Payloads:

* ``add``    — ``n u32 | dim u32 | ids int64[n] | rows f32[n, dim]``
  (the rows AND the ids they were acknowledged under: replay must
  reproduce id assignment bit-for-bit).
* ``delete`` — ``n u32 | ids int64[n]``.
* ``marker`` — UTF-8 text (compaction/checkpoint breadcrumbs; replay
  ignores them).

fsync policy (``always`` / ``interval`` / ``off``) trades ack latency
against the durability horizon: ``always`` fsyncs every append (an
acknowledged mutation survives power loss), ``interval`` bounds the
loss window to ``fsync_interval_s``, ``off`` leaves it to the OS.
All three ``flush()`` every append, so a mere *process* crash never
loses acknowledged work under any policy.

The log is segmented (``wal-<startseq>.log``).  A checkpoint rotates
to a fresh segment under the mutation barrier (cheap), writes the
checkpoint off-lock, then drops every segment whose records are all
covered — the log stays bounded without stalling serving.

The log is host-side numpy and ``struct``: an add record carries the
float32 rows as submitted (the engine already holds them on the host),
so logging copies nothing from the card.  A checkpoint copies the
index's tensors to the host (``AshIndex.save``); :meth:`DurableIndex.open`
loads the checkpoint onto an explicit device (``index_opts``, default
``"cuda"``) and replays there, one record at a time.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import shutil
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.index.api import AshIndex, CorruptIndexError
from repro_torch.testing import faults

_MAGIC = b"AWAL"
_HEADER = struct.Struct("<4sBQII")  # magic, kind, seqno, len, crc32
_ADD_HEAD = struct.Struct("<II")  # n, dim
_DEL_HEAD = struct.Struct("<I")  # n

KIND_ADD = 1
KIND_DELETE = 2
KIND_MARKER = 3

_FAULT_APPEND = faults.point("wal.append", torn=True)
_FAULT_FSYNC = faults.point("wal.fsync")
_FAULT_ROTATE = faults.point("wal.rotate")
_FAULT_CKPT_BEGIN = faults.point("ckpt.begin")
_FAULT_CKPT_GC = faults.point("ckpt.gc")

_FSYNC_POLICIES = ("always", "interval", "off")


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded log record."""

    seqno: int
    kind: int  # KIND_ADD | KIND_DELETE | KIND_MARKER
    rows: Optional[np.ndarray] = None  # adds: (n, dim) float32
    ids: Optional[np.ndarray] = None  # adds/deletes: (n,) int64
    text: str = ""  # markers


def _encode_record(kind: int, seqno: int, payload: bytes) -> bytes:
    crc = zlib.crc32(
        struct.pack("<BQI", kind, seqno, len(payload)) + payload
    )
    return _HEADER.pack(_MAGIC, kind, seqno, len(payload), crc) + payload


def _decode_payload(kind: int, seqno: int, payload: bytes) -> WalRecord:
    if kind == KIND_ADD:
        n, dim = _ADD_HEAD.unpack_from(payload)
        off = _ADD_HEAD.size
        ids = np.frombuffer(payload, np.int64, n, off).copy()
        rows = np.frombuffer(
            payload, np.float32, n * dim, off + 8 * n
        ).reshape(n, dim).copy()
        return WalRecord(seqno, kind, rows=rows, ids=ids)
    if kind == KIND_DELETE:
        (n,) = _DEL_HEAD.unpack_from(payload)
        ids = np.frombuffer(payload, np.int64, n, _DEL_HEAD.size).copy()
        return WalRecord(seqno, kind, ids=ids)
    return WalRecord(seqno, kind, text=payload.decode("utf-8", "replace"))


def _scan_segment(
    data: bytes, path: pathlib.Path
) -> Tuple[List[WalRecord], int]:
    """Parse one segment's bytes into (records, valid_end): the byte
    offset of the last record that passed framing + crc.  Anything
    past ``valid_end`` is a torn or corrupt tail."""
    records: List[WalRecord] = []
    off = 0
    while True:
        if off + _HEADER.size > len(data):
            return records, off
        magic, kind, seqno, plen, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            return records, off
        end = off + _HEADER.size + plen
        if end > len(data):
            return records, off  # torn payload
        payload = data[off + _HEADER.size:end]
        want = zlib.crc32(
            struct.pack("<BQI", kind, seqno, plen) + payload
        )
        if want != crc:
            return records, off
        try:
            records.append(_decode_payload(kind, seqno, payload))
        except Exception:
            return records, off  # framed but undecodable: treat as torn
        off = end


def _segment_start(path: pathlib.Path) -> int:
    return int(path.stem.split("-", 1)[1])


class WriteAheadLog:
    """Append side of the log.  Thread-compatible: appends are assumed
    to be serialized by the caller (the engine holds the per-index
    mutation barrier around every append), rotation included."""

    def __init__(
        self,
        directory,
        *,
        fsync: str = "interval",
        fsync_interval_s: float = 0.05,
        start_seqno: int = 0,
    ):
        if fsync not in _FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {_FSYNC_POLICIES}: {fsync!r}"
            )
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        self._seqno = int(start_seqno)
        self._last_fsync = time.perf_counter()
        self._appends = 0
        self._appended_bytes = 0
        self._fsyncs = 0
        self._rotations = 0
        self._f = None
        self._open_segment()

    # -- segments -----------------------------------------------------

    def _open_segment(self) -> None:
        self._seg_path = self.dir / f"wal-{self._seqno + 1:020d}.log"
        self._f = open(self._seg_path, "ab")

    def rotate(self) -> None:
        """Close the active segment and start a fresh one at the next
        seqno (the checkpoint hook; cheap enough for the barrier)."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        faults.fire(_FAULT_ROTATE)
        self._open_segment()
        # The new segment's directory entry must be durable BEFORE any
        # checkpoint GC unlinks the segments it supersedes: a power
        # loss after drop_segments_through with the dirent still in
        # the page cache would leave a log whose covered prefix is
        # gone AND whose active segment never existed.
        _dir_fsync(self.dir)
        self._rotations += 1

    def drop_segments_through(self, seqno: int) -> int:
        """Delete closed segments whose every record is <= ``seqno``
        (i.e. covered by a checkpoint).  Returns segments removed."""
        segs = sorted(
            p for p in self.dir.glob("wal-*.log") if p != self._seg_path
        )
        starts = [_segment_start(p) for p in segs]
        # segment i spans [starts[i], next start - 1]; the active
        # segment starts at self._active_start()
        bounds = starts[1:] + [_segment_start(self._seg_path)]
        dropped = 0
        for path, nxt in zip(segs, bounds):
            if nxt - 1 <= seqno:
                path.unlink(missing_ok=True)
                dropped += 1
        if dropped:
            _dir_fsync(self.dir)
        return dropped

    def segments(self) -> Tuple[pathlib.Path, ...]:
        return tuple(sorted(self.dir.glob("wal-*.log")))

    @property
    def nbytes(self) -> int:
        self._f.flush()
        return sum(p.stat().st_size for p in self.segments())

    # -- appends ------------------------------------------------------

    @property
    def last_seqno(self) -> int:
        return self._seqno

    def append_add(self, rows, ids) -> int:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        if rows.ndim != 2 or ids.shape != (rows.shape[0],):
            raise ValueError(
                f"add record needs (n, dim) rows + (n,) ids: "
                f"{rows.shape} / {ids.shape}"
            )
        payload = (
            _ADD_HEAD.pack(rows.shape[0], rows.shape[1])
            + ids.tobytes()
            + rows.tobytes()
        )
        return self._append(KIND_ADD, payload)

    def append_delete(self, ids) -> int:
        ids = np.ascontiguousarray(
            np.asarray(ids).reshape(-1), dtype=np.int64
        )
        return self._append(
            KIND_DELETE, _DEL_HEAD.pack(ids.size) + ids.tobytes()
        )

    def append_marker(self, text: str) -> int:
        return self._append(KIND_MARKER, text.encode("utf-8"))

    def _append(self, kind: int, payload: bytes) -> int:
        seq = self._seqno + 1
        record = _encode_record(kind, seq, payload)
        cut = faults.fire(_FAULT_APPEND, size=len(record))
        if cut is not None:
            # injected torn write: the prefix reaches the OS, then the
            # process "dies" — recovery must truncate it
            self._f.write(record[:cut])
            self._f.flush()
            raise faults.SimulatedCrash(
                f"torn WAL append at seqno {seq} ({cut}/{len(record)}B)"
            )
        self._f.write(record)
        self._f.flush()  # past the process: a crash can't unwrite it
        self._seqno = seq
        self._appends += 1
        self._appended_bytes += len(record)
        if self.fsync == "always":
            self._do_fsync()
        elif self.fsync == "interval":
            now = time.perf_counter()
            if now - self._last_fsync >= self.fsync_interval_s:
                self._do_fsync()
        return seq

    def _do_fsync(self) -> None:
        faults.fire(_FAULT_FSYNC)
        os.fsync(self._f.fileno())
        self._fsyncs += 1
        self._last_fsync = time.perf_counter()

    def sync(self) -> None:
        """Force an fsync regardless of policy."""
        self._f.flush()
        self._do_fsync()

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()

    def stats(self) -> Dict[str, Any]:
        return {
            "last_seqno": self._seqno,
            "appends": self._appends,
            "appended_bytes": self._appended_bytes,
            "fsyncs": self._fsyncs,
            "rotations": self._rotations,
            "segments": len(self.segments()),
            "fsync": self.fsync,
        }


def _dir_fsync(path: pathlib.Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_log(
    directory, *, truncate: bool = False
) -> Tuple[List[WalRecord], int]:
    """Read every intact record under ``directory`` in seqno order;
    returns (records, torn_bytes).  The durable set is a *prefix*:
    reading stops at the first torn/corrupt record, and later segments
    are not replayed (they would leave a seqno gap).  With
    ``truncate=True`` the torn tail is cut off on disk and later
    segments deleted, so the next append cycle starts clean."""
    d = pathlib.Path(directory)
    records: List[WalRecord] = []
    torn = 0
    clean = True
    for path in sorted(d.glob("wal-*.log")):
        data = path.read_bytes()
        if not clean:
            torn += len(data)
            if truncate:
                path.unlink(missing_ok=True)
            continue
        recs, valid_end = _scan_segment(data, path)
        records.extend(recs)
        if valid_end != len(data):
            clean = False
            torn += len(data) - valid_end
            if truncate:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
    for i in range(1, len(records)):
        if records[i].seqno != records[i - 1].seqno + 1:
            raise CorruptIndexError(
                d,
                f"WAL seqno gap: {records[i - 1].seqno} -> "
                f"{records[i].seqno}",
            )
    return records, torn


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What :meth:`DurableIndex.open` found and did."""

    checkpoint_path: str
    checkpoint_seqno: int  # WAL high-water mark the checkpoint covers
    last_seqno: int  # durable high-water mark after replay
    replayed_adds: int = 0
    replayed_deletes: int = 0
    replayed_rows: int = 0  # rows added + tombstoned by replay
    skipped_stale: int = 0  # records <= checkpoint_seqno (idempotence)
    torn_bytes: int = 0  # truncated off the WAL tail
    discarded_checkpoints: int = 0  # corrupt ckpts skipped over
    load_s: float = 0.0  # host clock: checkpoint load onto the device
    replay_s: float = 0.0  # host clock: reading the log and replaying it

    def describe(self) -> str:
        return (
            f"checkpoint seq={self.checkpoint_seqno} "
            f"replayed={self.replayed_adds} adds/"
            f"{self.replayed_deletes} dels "
            f"({self.replayed_rows} rows, {self.skipped_stale} stale) "
            f"torn_bytes={self.torn_bytes} last_seq={self.last_seqno} "
            f"load={self.load_s:.2f}s replay={self.replay_s:.2f}s"
        )


class DurableIndex:
    """An :class:`AshIndex` (on its device) bound to a durability
    directory::

        path/
          ckpt-<seqno>/   atomic checkpoints (arrays.npz + manifest)
          wal/            segmented mutation log

    Attach to a :class:`~repro_torch.serving.engine.QueryEngine` via
    ``engine.attach_durability(durable)`` — the apply path then logs
    every mutation batch before its tickets resolve.  After any crash,
    :meth:`open` restores exactly the acknowledged state.
    """

    def __init__(
        self,
        index: AshIndex,
        path,
        wal: WriteAheadLog,
        report: Optional[RecoveryReport] = None,
    ):
        self.index = index
        self.path = pathlib.Path(path)
        self.wal = wal
        self.report = report
        self._checkpoints = 0
        self._checkpoint_seqno = (
            0 if report is None else report.checkpoint_seqno
        )
        self._lock = threading.Lock()  # checkpoint vs checkpoint

    # -- construction -------------------------------------------------

    @classmethod
    def create(
        cls,
        index: AshIndex,
        path,
        *,
        fsync: str = "interval",
        fsync_interval_s: float = 0.05,
    ) -> "DurableIndex":
        """Start durability for ``index`` at ``path`` (must not hold a
        checkpoint already): writes checkpoint 0 and opens the log."""
        p = pathlib.Path(path)
        if any(p.glob("ckpt-*")):
            raise FileExistsError(
                f"{p} already holds checkpoints; use DurableIndex.open"
            )
        p.mkdir(parents=True, exist_ok=True)
        wal = WriteAheadLog(
            p / "wal", fsync=fsync, fsync_interval_s=fsync_interval_s,
            start_seqno=0,
        )
        durable = cls(index, p, wal)
        durable.checkpoint()
        return durable

    @staticmethod
    def exists(path) -> bool:
        """True if ``path`` holds at least one checkpoint dir."""
        return any(pathlib.Path(path).glob("ckpt-*"))

    @classmethod
    def open(
        cls,
        path,
        *,
        fsync: str = "interval",
        fsync_interval_s: float = 0.05,
        index_opts: Optional[dict] = None,
    ) -> "DurableIndex":
        """Recover: load the newest checkpoint that passes integrity
        checks, truncate any torn WAL tail, replay surviving records
        past the checkpoint's high-water mark, and reopen the log for
        appending.  ``index_opts`` go to :meth:`AshIndex.load`
        (``device``, default ``"cuda"``; ``mesh``; ``hot_bytes``).
        Each add record replays as its own ``stage_add`` +
        ``apply_pending``, so the recovered index is bit-identical to
        the serial replay of the acknowledged mutations."""
        p = pathlib.Path(path)
        t_load = time.perf_counter()
        candidates = sorted(p.glob("ckpt-*"), reverse=True)
        if not candidates:
            raise CorruptIndexError(p, "no checkpoints found")
        index = None
        discarded = 0
        last_err: Optional[Exception] = None
        for ckpt in candidates:
            try:
                index = AshIndex.load(ckpt, **(index_opts or {}))
                break
            except CorruptIndexError as e:
                discarded += 1
                last_err = e
        if index is None:
            raise CorruptIndexError(
                p, f"no valid checkpoint among {len(candidates)}: "
                   f"{last_err}"
            )
        hwm = int(
            json.loads((ckpt / "config.json").read_text())
            .get("wal_seqno", 0)
        )
        t_replay = time.perf_counter()
        records, torn = read_log(p / "wal", truncate=True)
        adds = dels = rows = stale = 0
        prev = None
        for rec in records:
            if rec.seqno <= hwm:
                stale += 1
                continue
            if prev is not None and rec.seqno != prev + 1:
                raise CorruptIndexError(
                    p / "wal",
                    f"replay seqno gap: {prev} -> {rec.seqno}",
                )
            if prev is None and rec.seqno != hwm + 1:
                raise CorruptIndexError(
                    p / "wal",
                    f"WAL starts at seqno {rec.seqno}, checkpoint "
                    f"covers through {hwm}",
                )
            prev = rec.seqno
            if rec.kind == KIND_ADD:
                got = index.stage_add(rec.rows)
                if not np.array_equal(got, rec.ids):
                    raise CorruptIndexError(
                        p / "wal",
                        f"replay id mismatch at seqno {rec.seqno}: "
                        f"assigned {got[:4]}.. != logged {rec.ids[:4]}..",
                    )
                index.apply_pending()
                adds += 1
                rows += int(rec.rows.shape[0])
            elif rec.kind == KIND_DELETE:
                rows += index.delete(rec.ids)
                dels += 1
            # markers replay as no-ops
        last = records[-1].seqno if records else hwm
        last = max(last, hwm)
        wal = WriteAheadLog(
            p / "wal", fsync=fsync, fsync_interval_s=fsync_interval_s,
            start_seqno=last,
        )
        report = RecoveryReport(
            checkpoint_path=str(ckpt),
            checkpoint_seqno=hwm,
            last_seqno=last,
            replayed_adds=adds,
            replayed_deletes=dels,
            replayed_rows=rows,
            skipped_stale=stale,
            torn_bytes=torn,
            discarded_checkpoints=discarded,
            load_s=t_replay - t_load,
            replay_s=time.perf_counter() - t_replay,
        )
        return cls(index, p, wal, report)

    # -- the engine-facing logging surface ----------------------------

    def log_add(self, rows, ids) -> int:
        """Append an acknowledged add batch; returns its seqno.  The
        engine calls this under the index's mutation barrier, before
        the batch's tickets fire."""
        return self.wal.append_add(rows, ids)

    def log_delete(self, ids) -> int:
        return self.wal.append_delete(ids)

    def log_marker(self, text: str) -> int:
        return self.wal.append_marker(text)

    # -- checkpointing ------------------------------------------------

    def checkpoint(self, *, barrier=None) -> int:
        """Checkpoint-then-truncate: snapshot the index state and the
        WAL high-water mark (under ``barrier`` if given — pass the
        engine's ``mutation_barrier`` so the pair is consistent),
        rotate the log, write the checkpoint atomically OFF the lock,
        then GC checkpoints and covered segments.  Returns the seqno
        the new checkpoint covers.  Crash-safe at every step: until
        the final rename the old checkpoint + full log win."""
        with self._lock:
            cm = barrier if barrier is not None \
                else contextlib.nullcontext()
            with cm:
                # no mutation writes a state's tensors in place (each
                # returns new tensors, or rebinds attributes of the
                # live state object), so this shallow copy stays the
                # state as of the barrier while the save below runs
                state = copy.copy(self.index._state)
                hwm = self.wal.last_seqno
                self.wal.rotate()
            faults.fire(_FAULT_CKPT_BEGIN)
            ckpt_dir = self.path / f"ckpt-{hwm:020d}"
            if not ckpt_dir.exists():
                # the clone holds state only: staged-but-unlogged rows
                # are NOT durable yet (their tickets haven't fired), so
                # they are excluded and replay of their eventual WAL
                # records reassigns the very same ids
                clone = AshIndex(
                    self.index.backend, self.index.metric, state
                )
                clone.save(ckpt_dir, extra_meta={"wal_seqno": hwm})
            faults.fire(_FAULT_CKPT_GC)
            for d in sorted(self.path.glob("ckpt-*")):
                if d != ckpt_dir:
                    shutil.rmtree(d, ignore_errors=True)
            self.wal.drop_segments_through(hwm)
            self._checkpoints += 1
            self._checkpoint_seqno = hwm
            return hwm

    def close(self) -> None:
        self.wal.close()

    def stats(self) -> Dict[str, Any]:
        s = self.wal.stats()
        s.update(
            checkpoints=self._checkpoints,
            checkpoint_seqno=self._checkpoint_seqno,
        )
        return s
