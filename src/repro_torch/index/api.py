"""``AshIndex``: one build/search/persist surface over the flat, IVF,
sharded and tiered IVF backends.

Counterpart of ``repro.index.api``::

    index = AshIndex.build(gen, X, ASHConfig(b=2, d=64, n_landmarks=64),
                           metric="l2", keep_raw=True)   # on "cuda"
    scores, ids = index.search(queries, k=10, rerank=100)
    scores, ids = index.search(queries, k=10, coarse="int8", shortlist=64)
    ivf = AshIndex.build(gen, X, cfg, backend="ivf")     # nlist = C
    scores, ids = ivf.search(queries, k=10, nprobe=8)
    sharded = AshIndex.build(gen, X, cfg, backend="sharded",
                             mesh=[torch.device("cuda", i) for i in ...])
    tiered = AshIndex.build(gen, X, cfg, backend="tiered_ivf",
                            hot_bytes=64 << 20)  # lists paged from host
    index.add(X_new); index.delete([3, 17]); index.compact()
    ids = index.stage_add(X_more)       # buffered; ids assigned now
    index.apply_pending()               # one backend add for the batch
    index.save("/tmp/idx")
    index = AshIndex.load("/tmp/idx")

The on-disk format is the reference's: ``arrays.npz`` plus a
``config.json`` manifest holding a crc32 per array, with bf16 arrays
stored as uint16 bit patterns tagged ``"bfloat16"``.  An index saved by
either package loads into the other.  Saves are atomic (a temp dir and
one rename for a fresh target; ``.new`` files renamed in order over an
existing one, rolled forward by :meth:`AshIndex.load`).
"""
from __future__ import annotations

import copy
import json
import os
import pathlib
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import ash as A
from repro_torch.core import scoring as S
from repro_torch.core.types import (
    ASHConfig, ASHModel, ASHPayload, ASHStats, QueryPrep,
)
from repro_torch.device import resolve_device
from repro_torch.index import common as C
from repro_torch.index import distributed as DX
from repro_torch.index import flat as F
from repro_torch.index import ivf as IV
from repro_torch.testing import faults

FORMAT_VERSION = 1


class CorruptIndexError(ValueError):
    """A saved index failed an integrity check on load; names where and
    which check."""

    def __init__(self, path, check: str):
        self.path = str(path)
        self.check = check
        super().__init__(f"corrupt index at {self.path}: {check}")


_BACKENDS: dict[str, type] = {}


def register_backend(cls):
    """Class decorator: register an index backend under ``cls.name``."""
    _BACKENDS[cls.name] = cls
    return cls


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def _get_backend(name: str):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


# ---------------------------------------------------------------------------
# Array (de)serialization: numpy .npz, bf16 stored as uint16 bit patterns
# ---------------------------------------------------------------------------

_STATS_FIELDS = ("res_norm", "ip_x_mu", "x_sq")


def _encode_array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """Tensor -> (savez-safe numpy array, dtype tag)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _decode_array(a: np.ndarray, tag: str, device) -> torch.Tensor:
    if tag == "bfloat16":
        a = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:  # packed codes travel as int32 bit patterns
        a = np.ascontiguousarray(a).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# crash points of an atomic save: before the fresh target's directory
# rename, and between the two file renames of an over-save (new arrays
# under the old manifest, which load() rolls forward)
_FAULT_SAVE_REPLACE = faults.point("save.replace")
_FAULT_SAVE_BETWEEN = faults.point("save.between_replace")


def _fsync_dir(path: pathlib.Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return  # platform without directory fsync
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_npz(path: pathlib.Path, encoded: dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        np.savez(f, **encoded)
        f.flush()
        os.fsync(f.fileno())


def _write_manifest(path: pathlib.Path, meta: dict[str, Any]) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(meta, indent=2))
        f.flush()
        os.fsync(f.fileno())


def _save_fresh(p: pathlib.Path, encoded, meta) -> None:
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.parent / f".{p.name}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    _write_npz(tmp / "arrays.npz", encoded)
    _write_manifest(tmp / "config.json", meta)
    _fsync_dir(tmp)
    faults.fire(_FAULT_SAVE_REPLACE)
    os.replace(tmp, p)
    _fsync_dir(p.parent)


def _save_over(p: pathlib.Path, encoded, meta) -> None:
    _write_npz(p / "arrays.new.npz", encoded)
    _write_manifest(p / "config.new.json", meta)
    _fsync_dir(p)
    os.replace(p / "arrays.new.npz", p / "arrays.npz")
    faults.fire(_FAULT_SAVE_BETWEEN)
    os.replace(p / "config.new.json", p / "config.json")
    _fsync_dir(p)


def _read_index_files(p: pathlib.Path, manifest: str = "config.json"):
    """Read and integrity-check one (manifest, arrays.npz) pair; returns
    (meta, encoded arrays).  Every failure raises CorruptIndexError."""
    mpath = p / manifest
    if not mpath.is_file():
        raise CorruptIndexError(p, f"{manifest} missing")
    try:
        meta = json.loads(mpath.read_text())
    except (ValueError, OSError) as e:
        raise CorruptIndexError(p, f"{manifest} unreadable: {e}") from e
    if not isinstance(meta, dict) or "format_version" not in meta:
        raise CorruptIndexError(p, f"{manifest} is not an index manifest")
    if meta["format_version"] != FORMAT_VERSION:
        raise CorruptIndexError(
            p, f"format_version {meta['format_version']} != {FORMAT_VERSION}"
        )
    apath = p / "arrays.npz"
    if not apath.is_file():
        raise CorruptIndexError(p, "arrays.npz missing")
    try:
        with np.load(apath) as npz:
            encoded = {name: np.asarray(npz[name]) for name in npz.files}
    except Exception as e:  # BadZipFile / ValueError / zlib / EOF / OS
        raise CorruptIndexError(p, f"arrays.npz unreadable: {e}") from e
    for name in encoded:
        if name not in meta.get("dtypes", {}):
            raise CorruptIndexError(
                p, f"arrays.npz entry {name!r} missing from manifest dtypes"
            )
    checksums = meta.get("checksums")
    if checksums is not None:
        missing = set(checksums) - set(encoded)
        if missing:
            raise CorruptIndexError(
                p, f"arrays.npz missing entries {sorted(missing)}"
            )
        extra = set(encoded) - set(checksums)
        if extra:
            raise CorruptIndexError(
                p, f"arrays.npz has unmanifested entries {sorted(extra)}"
            )
        for name, want in checksums.items():
            got = zlib.crc32(np.ascontiguousarray(encoded[name]).tobytes())
            if got != want:
                raise CorruptIndexError(
                    p, f"checksum mismatch for {name!r}: "
                    f"crc32 {got:#010x} != manifest {want:#010x}",
                )
    return meta, encoded


def _read_index_dir(p: pathlib.Path):
    """:func:`_read_index_files`, rolling forward an over-save that was
    interrupted between its two renames."""
    try:
        return _read_index_files(p)
    except CorruptIndexError as err:
        if not (p / "config.new.json").is_file():
            raise
        try:
            meta, encoded = _read_index_files(p, "config.new.json")
        except CorruptIndexError:
            raise err from None
        os.replace(p / "config.new.json", p / "config.json")
        (p / "arrays.new.npz").unlink(missing_ok=True)
        _fsync_dir(p)
        return meta, encoded


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


def _common_arrays(state) -> dict:
    """Model, payload and stats arrays under the reference's names."""
    arrays = {
        **{f"model.{f}": getattr(state.model, f)
           for f in ASHModel.ARRAY_FIELDS},
        **{f"payload.{f}": getattr(state.payload, f)
           for f in ASHPayload.ARRAY_FIELDS},
    }
    if state.stats is not None:
        arrays.update({f"stats.{f}": getattr(state.stats, f)
                       for f in _STATS_FIELDS})
    return arrays


def _common_from_arrays(arrays, config):
    """(model, payload, stats) of :func:`_common_arrays`; stats are
    recomputed when the save has none."""
    model = ASHModel(config=config, **{
        f: arrays[f"model.{f}"].to(torch.float32)
        for f in ASHModel.ARRAY_FIELDS
    })
    payload = ASHPayload(b=config.b, d=config.d, **{
        f: arrays[f"payload.{f}"] for f in ASHPayload.ARRAY_FIELDS
    })
    if all(f"stats.{f}" in arrays for f in _STATS_FIELDS):
        stats = ASHStats(**{f: arrays[f"stats.{f}"] for f in _STATS_FIELDS})
    else:
        stats = S.payload_stats(model, payload)
    return model, payload, stats


def _next_id_meta(state) -> dict:
    return {} if state.next_id is None else {"next_id": int(state.next_id)}


@register_backend
class FlatBackend:
    """Exhaustive scan over the whole payload."""

    name = "flat"

    build = staticmethod(F._build)
    add = staticmethod(F._add)
    delete = staticmethod(F._delete)
    compact = staticmethod(F._compact)

    @staticmethod
    def search(state, queries, *, k, nprobe=None, rerank=0, **opts):
        del nprobe  # no list routing in a flat scan
        return F._search(state, queries, k=k, rerank=rerank, **opts)

    @staticmethod
    def search_prepped(state, prep, *, k, nprobe=None, rerank=0, **opts):
        del nprobe
        return F._search_prepped(state, prep, k=k, rerank=rerank, **opts)

    @staticmethod
    def from_parts(model, payload, *, metric, raw=None):
        return F.FlatIndex(
            metric=metric, model=model, payload=payload, raw=raw,
            stats=S.payload_stats(model, payload),
            coarse=S.coarse_codes(payload),
        )

    @staticmethod
    def next_id_of(state):
        return C.effective_next_id(state.next_id, state.ids, state.payload.n)

    @staticmethod
    def to_arrays(state):
        arrays = _common_arrays(state)
        for name in ("raw", "ids", "live"):
            if getattr(state, name) is not None:
                arrays[name] = getattr(state, name)
        return arrays, _next_id_meta(state)

    @staticmethod
    def from_arrays(arrays, meta, config, metric):
        model, payload, stats = _common_from_arrays(arrays, config)
        return F.FlatIndex(
            metric=metric, model=model, payload=payload,
            raw=arrays.get("raw"), stats=stats, ids=arrays.get("ids"),
            live=arrays.get("live"), next_id=meta.get("next_id"),
            coarse=S.coarse_codes(payload),
        )


@register_backend
class IVFBackend:
    """Inverted-file routing over the landmark coarse quantizer."""

    name = "ivf"
    default_nprobe = 8

    build = staticmethod(IV._build)
    add = staticmethod(IV._add)
    delete = staticmethod(IV._delete)
    compact = staticmethod(IV._compact)

    @staticmethod
    def from_parts(model, payload, *, metric, raw=None):
        ids = torch.arange(payload.n, dtype=torch.int32,
                           device=payload.codes.device)
        return IV._assemble(metric, model, payload, ids, raw)

    @staticmethod
    def resolve_nprobe(state, nprobe):
        """Effective nprobe: the default applied, clamped to the list
        count."""
        if nprobe is None:
            nprobe = IVFBackend.default_nprobe
        return min(nprobe, state.invlists.shape[0])

    @staticmethod
    def search(state, queries, *, k, nprobe=None, rerank=0, **opts):
        nprobe = IVFBackend.resolve_nprobe(state, nprobe)
        return IV._search(state, queries, k=k, nprobe=nprobe,
                          rerank=rerank, **opts)

    @staticmethod
    def search_prepped(state, prep, *, k, nprobe=None, rerank=0, **opts):
        nprobe = IVFBackend.resolve_nprobe(state, nprobe)
        return IV._search_prepped(state, prep, k=k, nprobe=nprobe,
                                  rerank=rerank, **opts)

    @staticmethod
    def probe_sets(state, prep, nprobe=None) -> np.ndarray:
        """Host-visible coarse assignment: (m, nprobe) int32 probed list
        ids per query, best first: the lists the gathered search scans
        at that nprobe (a smaller nprobe's set is a column prefix)."""
        nprobe = IVFBackend.resolve_nprobe(state, nprobe)
        return IV._probe_lists(state, prep, nprobe).to(
            torch.int32).cpu().numpy()

    @staticmethod
    def search_probed(state, prep, probe, *, k, rerank=0, **opts):
        """Top-k over an explicit probed-list set, as returned by
        :meth:`probe_sets`."""
        return IV._search_probed(
            state, prep, torch.as_tensor(probe, dtype=torch.int32), k=k,
            rerank=rerank, **opts,
        )

    @staticmethod
    def list_sizes(state) -> np.ndarray:
        """Live rows per inverted list, host numpy (nlist,) int64: what
        probing a list costs the gathered scan (tombstoned rows are
        dropped from the candidate table, so they cost nothing)."""
        valid = state.invlists >= 0
        if state.live is not None:
            valid &= state.live[state.invlists.clamp(min=0).long()]
        return valid.sum(dim=1).cpu().numpy().astype(np.int64)

    @staticmethod
    def next_id_of(state):
        return C.effective_next_id(state.next_id, state.ids, state.payload.n)

    @staticmethod
    def to_arrays(state):
        arrays = {**_common_arrays(state), "ids": state.ids,
                  "invlists": state.invlists}
        for name in ("raw", "live"):
            if getattr(state, name) is not None:
                arrays[name] = getattr(state, name)
        return arrays, {"max_list_len": state.max_list_len,
                        **_next_id_meta(state)}

    @staticmethod
    def from_arrays(arrays, meta, config, metric):
        model, payload, stats = _common_from_arrays(arrays, config)
        return IV.IVFIndex(
            metric=metric, max_list_len=int(meta["max_list_len"]),
            model=model, payload=payload, ids=arrays["ids"],
            invlists=arrays["invlists"], raw=arrays.get("raw"),
            stats=stats, live=arrays.get("live"),
            next_id=meta.get("next_id"),
            coarse=S.coarse_codes(payload),
        )


def _host(t):
    """A tensor (or None) on the CPU."""
    return None if t is None else t.detach().cpu()


def _default_mesh(device) -> list[torch.device]:
    """One shard per visible card, or one CPU shard."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ShardedState:
    """The unpadded rows on the host and their row-sharded placement.

    The host tensors (payload, encode-time stats, bf16 raw rows for
    rerank, user ids, the tombstone bitmap) are the source of truth that
    add/delete/compact/save work on; ``shards`` (a
    ``distributed.ShardSet``) is what searches scan: the payload padded
    to a multiple of the shard count, split into equal row blocks, block
    ``s`` on ``devices[s]``.  A delete re-places only the bitmap.  The
    model lives on ``devices[0]``, where queries are prepared and
    results merged.
    """

    def __init__(self, *, metric, model, payload, devices, axes, raw=None,
                 stats=None, ids=None, live=None, next_id=None):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a sharded index needs at least one device")
        cluster = payload.cluster
        if cluster.numel() and int(cluster.min()) < 0:
            raise ValueError(
                "pad-sentinel cluster ids in the host payload; construct "
                "ShardedState from an unpadded payload")
        self.metric = metric
        self.devices = devices
        self.axes = tuple(axes)
        self.model = DX.model_to(model, devices[0])
        self.payload = ASHPayload(b=payload.b, d=payload.d, **{
            f: _host(getattr(payload, f)) for f in ASHPayload.ARRAY_FIELDS})
        if stats is None:
            dev_payload = DX.shard_rows([devices[0]], payload)[0]
            stats = S.payload_stats(self.model, dev_payload)
        self.stats = ASHStats(**{f: _host(getattr(stats, f))
                                 for f in _STATS_FIELDS})
        self.raw = _host(raw)
        self.ids = _host(ids)
        self.live = _host(live)
        self.next_id = next_id
        self.place()

    def _pad(self) -> int:
        return (-self.payload.n) % len(self.devices)

    def _padded_valid(self):
        if self.live is None:
            return None
        return DX.pad_rows(self.live.to(torch.bool), self._pad(), False)

    def place(self) -> None:
        """(Re-)place every shard from the host tensors."""
        pad = self._pad()
        self.shards = DX.ShardSet(
            self.devices, self.model,
            DX.pad_to_multiple(self.payload, len(self.devices)),
            stats=DX.pad_stats(self.stats, pad),
            raw=None if self.raw is None else DX.pad_rows(self.raw, pad),
            valid=self._padded_valid())
        self.ids_dev = None if self.ids is None else self.ids.to(
            self.devices[0])

    def place_valid(self) -> None:
        """Re-place only the tombstone bitmap (payload, stats and raw
        shards stay); the shard set is copied, not changed, so a
        snapshot taken before keeps its own."""
        self.shards = self.shards.with_valid(self._padded_valid())


@register_backend
class ShardedBackend:
    """Row shards over a list of devices, searched scatter-gather from
    one process (``distributed.search_shards``); results equal the flat
    backend's, except that exact rerank and the coarse shortlist run per
    shard, as the reference's."""

    name = "sharded"

    @staticmethod
    def _resolve(mesh, axes, device):
        mesh = _default_mesh(device) if mesh is None else list(mesh)
        return mesh, tuple(axes) if axes is not None else ("data",)

    @staticmethod
    def build(gen, X, config, *, metric, device="cuda", mesh=None, axes=None,
              **opts):
        """``mesh``: one device per shard (default: one per visible
        card); ``opts`` as the flat backend's build."""
        mesh, axes = ShardedBackend._resolve(mesh, axes, device)
        flat = F._build(gen, X, config, metric=metric, device=mesh[0],
                        **opts)
        return ShardedState(metric=metric, model=flat.model,
                            payload=flat.payload, devices=mesh, axes=axes,
                            raw=flat.raw, stats=flat.stats)

    @staticmethod
    def from_parts(model, payload, *, metric, raw=None, mesh=None,
                   axes=None):
        mesh, axes = ShardedBackend._resolve(mesh, axes, model.device)
        return ShardedState(metric=metric, model=model, payload=payload,
                            devices=mesh, axes=axes, raw=raw)

    @staticmethod
    def search(state, queries, *, k, nprobe=None, rerank=0, **opts):
        prep = S.prepare_queries(state.model, queries)
        return ShardedBackend.search_prepped(state, prep, k=k, rerank=rerank,
                                             **opts)

    @staticmethod
    def search_prepped(state, prep, *, k, nprobe=None, rerank=0,
                       use_kernel=True, coarse=None, shortlist=None):
        del nprobe  # no list routing in the scatter-gather scan
        if rerank and state.raw is None:
            raise ValueError(
                "rerank on the sharded backend requires keep_raw=True "
                "(bf16 raw rows are sharded with the payload)")
        s, rows = DX.search_shards(
            state.shards, prep, k, metric=state.metric, rerank=rerank,
            use_kernel=use_kernel, coarse=coarse, shortlist=shortlist)
        if state.ids_dev is None:
            return s, rows
        return s, torch.where(rows < 0, -1,
                              state.ids_dev[rows.clamp(min=0).long()])

    @staticmethod
    def add(state, X_new):
        """Encode under the model, append stats, raw, ids and liveness
        for the new rows, then re-place every shard."""
        dev = state.model.device
        X_new = X_new.to(dev)
        payload_new = A.encode(state.model, X_new)
        n_new = payload_new.n
        nid = C.effective_next_id(state.next_id, state.ids, state.payload.n)
        state.payload = C.concat_payloads(state.payload, ASHPayload(
            b=payload_new.b, d=payload_new.d, **{
                f: _host(getattr(payload_new, f))
                for f in ASHPayload.ARRAY_FIELDS}))
        stats_new = S.payload_stats(state.model, payload_new)
        state.stats = C.concat_stats(state.stats, ASHStats(**{
            f: _host(getattr(stats_new, f)) for f in _STATS_FIELDS}))
        if state.raw is not None:
            state.raw = torch.cat([state.raw,
                                   _host(X_new.to(torch.bfloat16))])
        if state.ids is not None:
            state.ids = torch.cat([
                state.ids, nid + torch.arange(n_new, dtype=torch.int32)])
        if state.live is not None:
            state.live = torch.cat([state.live,
                                    torch.ones(n_new, dtype=torch.bool)])
        if state.next_id is not None:
            state.next_id = nid + n_new
        state.place()
        return state

    @staticmethod
    def delete(state, ids):
        new_live, removed = C.mark_deleted(state.ids, state.live, ids,
                                           state.payload.n)
        if removed:
            state.live = torch.from_numpy(new_live)
            state.place_valid()
        return state, removed

    @staticmethod
    def compact(state):
        """Evict tombstoned rows; returns a new state (the one given is
        not changed, so a background compaction may work on a
        snapshot)."""
        if state.live is None:
            return state
        live_np = state.live.numpy().astype(bool)
        out = copy.copy(state)
        if live_np.all():
            out.live = None
            out.place_valid()
            return out
        if not live_np.any():
            raise ValueError(
                "compact() would evict every row; an empty index cannot "
                "be searched — keep at least one live row or rebuild")
        nid = C.effective_next_id(state.next_id, state.ids, state.payload.n)
        keep = torch.from_numpy(np.nonzero(live_np)[0].astype(np.int64))
        out.ids = (keep if state.ids is None else state.ids[keep]).to(
            torch.int32)
        out.next_id = nid
        out.payload = C.gather_payload(state.payload, keep)
        out.stats = C.take_stats(state.stats, keep)
        out.raw = None if state.raw is None else state.raw[keep]
        out.live = None
        out.place()
        return out

    @staticmethod
    def next_id_of(state):
        return C.effective_next_id(state.next_id, state.ids, state.payload.n)

    @staticmethod
    def to_arrays(state):
        arrays = _common_arrays(state)
        for name in ("raw", "ids", "live"):
            if getattr(state, name) is not None:
                arrays[name] = getattr(state, name)
        return arrays, {"axes": list(state.axes), **_next_id_meta(state)}

    @staticmethod
    def from_arrays(arrays, meta, config, metric, *, mesh=None, axes=None):
        model, payload, stats = _common_from_arrays(arrays, config)
        mesh, axes = ShardedBackend._resolve(
            mesh, axes or meta.get("axes"), model.device)
        return ShardedState(
            metric=metric, model=model, payload=payload, devices=mesh,
            axes=axes, raw=arrays.get("raw"), stats=stats,
            ids=arrays.get("ids"), live=arrays.get("live"),
            next_id=meta.get("next_id"))


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


class AshIndex:
    """Build / search / add / delete / compact / save / load.

    :meth:`delete` tombstones rows (a validity bitmap fed to the fused
    kernel's runtime mask operand, so deleted ids never surface);
    :meth:`compact` evicts them.  :meth:`stage_add` buffers rows on the
    host (ids assigned at once) until :meth:`apply_pending` ingests them
    in one backend add: the serving engine's batched mutations.
    Tombstones and staged rows both survive save/load.
    """

    def __init__(self, backend: str, metric: str, state):
        self._backend = _get_backend(backend)
        self._backend_name = backend
        self._metric = C.validate_metric(metric)
        self._state = state
        self._pending_add: list[np.ndarray] = []
        # bumped on every state rewrite (an add, a delete that removed
        # rows, an apply_pending that ingested rows, a compaction): the
        # background compactor compares epochs to detect a mutation
        # between its snapshot and its swap
        self._mutation_epoch = 0

    @classmethod
    def build(
        cls,
        gen: torch.Generator,
        X: torch.Tensor,
        config: ASHConfig,
        *,
        backend: str = "flat",
        metric: str = "dot",
        device="cuda",
        **opts,
    ) -> "AshIndex":
        """Train (or reuse ``model=``), encode ``X`` and assemble the
        index on ``device``.  ``opts``: ``keep_raw``, ``learned``,
        ``model``, any ``core.ash.train`` keyword, and per backend
        ``mesh``/``axes`` (sharded: one device per shard, default one
        per visible card) or ``hot_bytes`` (tiered_ivf: the device hot
        set's budget)."""
        impl = _get_backend(backend)
        C.validate_metric(metric)
        state = impl.build(
            gen, X, config, metric=metric, device=resolve_device(device),
            **opts,
        )
        return cls(backend, metric, state)

    @classmethod
    def from_parts(
        cls,
        model: ASHModel,
        payload: ASHPayload,
        *,
        backend: str = "flat",
        metric: str = "dot",
        raw: Optional[torch.Tensor] = None,
        **opts,
    ) -> "AshIndex":
        """Wrap an already-encoded (model, payload) pair (on their
        device); ``opts`` as :meth:`build`'s per-backend ones."""
        impl = _get_backend(backend)
        C.validate_metric(metric)
        return cls(backend, metric, impl.from_parts(
            model, payload, metric=metric, raw=raw, **opts))

    def search(self, queries, k: int = 10, *, nprobe: Optional[int] = None,
               rerank: int = 0, use_kernel: bool = True,
               coarse: Optional[str] = None,
               shortlist: Optional[int] = None):
        """Top-k search: (scores, ids), each (m, k), higher-is-better for
        every metric; id -1 marks a missing candidate.

        ``nprobe`` (IVF; default 8) lists are probed per query.
        ``coarse="int8"`` runs the symmetric int8 first pass and
        rescores its top ``shortlist`` rows asymmetrically; it equals
        ``coarse=None`` whenever the shortlist covers the scanned rows.
        ``use_kernel=False`` runs the plain versions of the kernels."""
        return self._backend.search(
            self._state, queries, k=k, nprobe=nprobe, rerank=rerank,
            use_kernel=use_kernel, coarse=coarse, shortlist=shortlist,
        )

    def prepare(self, queries) -> QueryPrep:
        """The per-query terms of Eq. (20) for :meth:`search_prepped`."""
        return S.prepare_queries(self.model, queries)

    def search_prepped(self, prep: QueryPrep, k: int = 10, *,
                       nprobe: Optional[int] = None, rerank: int = 0,
                       use_kernel: bool = True,
                       coarse: Optional[str] = None,
                       shortlist: Optional[int] = None):
        """:meth:`search` from precomputed query terms; row i of the
        result depends only on row i of ``prep``."""
        return self._backend.search_prepped(
            self._state, prep, k=k, nprobe=nprobe, rerank=rerank,
            use_kernel=use_kernel, coarse=coarse, shortlist=shortlist,
        )

    def add(self, X_new) -> "AshIndex":
        """Encode and ingest new vectors; ids continue past every id
        ever assigned.  Staged rows are applied first, so ids follow
        submission order.  Returns self."""
        self.apply_pending()
        self._state = self._backend.add(self._state, X_new)
        self._mutation_epoch += 1
        return self

    def stage_add(self, X_new) -> np.ndarray:
        """Buffer rows on the host for a later batched ingestion;
        returns the (n,) int64 user ids they will carry, assigned now in
        submission order.  Staged rows are invisible to search until
        :meth:`apply_pending`."""
        if isinstance(X_new, torch.Tensor):
            X_new = X_new.detach().cpu().numpy()
        X = np.ascontiguousarray(np.asarray(X_new), dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        dim = self.model.landmarks.shape[1]
        if X.ndim != 2 or X.shape[1] != dim:
            raise ValueError(
                f"stage_add rows must be (n, {dim}): got {X.shape}"
            )
        start = self.next_id + self.pending_rows
        if X.shape[0]:
            self._pending_add.append(X)
        return np.arange(start, start + X.shape[0], dtype=np.int64)

    def apply_pending(self) -> int:
        """Ingest every staged row in one backend add; returns the rows
        applied (0 = nothing staged)."""
        if not self._pending_add:
            return 0
        rows = np.concatenate(self._pending_add, axis=0)
        self._pending_add = []
        self._state = self._backend.add(self._state, torch.from_numpy(rows))
        self._mutation_epoch += 1
        return rows.shape[0]

    def delete(self, ids) -> int:
        """Tombstone rows by user id; returns the rows newly removed
        (unknown or already-deleted ids are ignored).  Staged rows are
        applied first, so a just-staged id can be deleted."""
        self.apply_pending()
        self._state, removed = self._backend.delete(self._state, ids)
        if removed:
            self._mutation_epoch += 1
        return removed

    def compact(self, max_dead_fraction: float = 0.0) -> "AshIndex":
        """Evict tombstoned rows when the dead fraction exceeds
        ``max_dead_fraction``; user ids stay stable.  Staged rows are
        applied first.  Returns self."""
        self.apply_pending()
        if self.dead_fraction > max_dead_fraction:
            self._state = self._backend.compact(self._state)
            self._mutation_epoch += 1
        return self

    # -- persistence --------------------------------------------------

    def save(self, path, *, extra_meta: Optional[dict] = None) -> None:
        """Write ``arrays.npz`` + ``config.json`` under ``path/``
        atomically, in the reference's format."""
        p = pathlib.Path(path)
        arrays, backend_meta = self._backend.to_arrays(self._state)
        if self._pending_add:
            # staged rows ride along: a batched ingestion in flight is
            # not lost to a save/load cycle
            arrays["pending_add"] = torch.from_numpy(
                np.concatenate(self._pending_add, axis=0)
            )
        encoded, dtypes, checksums = {}, {}, {}
        for name, t in arrays.items():
            a, dtypes[name] = _encode_array(t)
            if name == "payload.codes":  # the reference's uint32 words
                a, dtypes[name] = a.view(np.uint32), "uint32"
            encoded[name] = a
            checksums[name] = zlib.crc32(
                np.ascontiguousarray(encoded[name]).tobytes()
            )
        cfg = self.config
        meta = {
            "format_version": FORMAT_VERSION,
            "backend": self._backend_name,
            "metric": self._metric,
            "config": {
                "b": cfg.b, "d": cfg.d, "n_landmarks": cfg.n_landmarks,
                "store_fp16": cfg.store_fp16,
            },
            "dtypes": dtypes,
            "backend_meta": backend_meta,
            "checksums": checksums,
        }
        if extra_meta:
            meta.update(extra_meta)
        if p.exists():
            _save_over(p, encoded, meta)
        else:
            _save_fresh(p, encoded, meta)

    @classmethod
    def load(cls, path, *, device="cuda", **opts) -> "AshIndex":
        """Inverse of :meth:`save` (either package's), onto ``device``;
        search results equal the saved index's.  ``opts`` override the
        backend's placement (``mesh``/``axes``, ``hot_bytes``).
        Integrity failures raise :class:`CorruptIndexError`."""
        dev = resolve_device(device)
        p = pathlib.Path(path)
        meta, encoded = _read_index_dir(p)
        pending = encoded.pop("pending_add", None)
        try:
            arrays = {
                name: _decode_array(a, meta["dtypes"][name], dev)
                for name, a in encoded.items()
            }
        except (TypeError, ValueError, KeyError) as e:
            raise CorruptIndexError(p, f"array decode failed: {e}") from e
        config = ASHConfig(**meta["config"])
        impl = _get_backend(meta["backend"])
        state = impl.from_arrays(
            arrays, meta["backend_meta"], config, meta["metric"], **opts
        )
        index = cls(meta["backend"], meta["metric"], state)
        if pending is not None:
            index._pending_add = [np.asarray(pending, dtype=np.float32)]
        return index

    # -- introspection ------------------------------------------------

    @property
    def backend(self) -> str:
        return self._backend_name

    @property
    def metric(self) -> str:
        return self._metric

    @property
    def model(self) -> ASHModel:
        return self._state.model

    @property
    def payload(self) -> ASHPayload:
        return self._state.payload

    @property
    def stats(self) -> Optional[ASHStats]:
        return self._state.stats

    @property
    def config(self) -> ASHConfig:
        return self.model.config

    @property
    def n(self) -> int:
        """Payload rows, including tombstones."""
        return self.payload.n

    @property
    def n_dead(self) -> int:
        live = self._state.live
        return 0 if live is None else self.n - int(live.sum())

    @property
    def n_live(self) -> int:
        return self.n - self.n_dead

    @property
    def dead_fraction(self) -> float:
        return self.n_dead / max(1, self.n)

    @property
    def pending_rows(self) -> int:
        """Rows staged by :meth:`stage_add`, not yet ingested."""
        return sum(p.shape[0] for p in self._pending_add)

    @property
    def mutation_epoch(self) -> int:
        """Count of state rewrites (adds applied, deletes that removed
        rows, compactions): equal epochs mean an unchanged searchable
        state, the background compactor's swap check."""
        return self._mutation_epoch

    @property
    def next_id(self) -> int:
        """User id the next added row receives (never reused); staged
        rows already hold theirs."""
        return self._backend.next_id_of(self._state)

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        cfg = self.config
        dead = ""
        if self.n_dead or self.pending_rows:
            dead = f", dead={self.n_dead}, pending={self.pending_rows}"
        return (
            f"AshIndex(backend={self._backend_name!r}, "
            f"metric={self._metric!r}, n={self.n}{dead}, b={cfg.b}, "
            f"d={cfg.d}, C={cfg.n_landmarks}, "
            f"payload={cfg.payload_bits()} bits/vec)"
        )
