"""Host-memory tiered IVF backend: indexes larger than the card's memory.

Counterpart of ``repro.index.tiered``.  Every other backend keeps the
whole payload on the device.  ``TieredIVFBackend`` keeps only the model
(landmarks == IVF centroids) and a byte-bounded hot set of inverted
lists there; the packed codes, the ``ASHStats`` columns, the user ids
and the bf16 raw rerank rows live per list in pinned host memory, in
the contiguous list-sorted row order ``ivf._assemble`` produces.

A search resolves the probe set on the card (the HBM backend's own
``ivf._probe_lists``), plans the union of the probed lists on the host
(``common.plan_paged_probe``), looks each list up in the hot set (the
serving layer's ``ByteLRU``), and pages every missed list in with ONE
host-to-device copy: the missed lists' fields are packed into one pinned
staging buffer, each field 16-byte aligned, copied with
``non_blocking=True``, and viewed on the device as typed tensors per
field (:func:`pack_blocks` / :func:`unpack_blocks`).  The staging buffer
comes from PyTorch's caching host allocator, which records an event on
the copy's stream and does not hand the block out again before the copy
has finished.  A list that fits the budget is kept in its own device
memory (a copy out of the transfer buffer, so that evicting it frees its
bytes); a block larger than the whole budget still serves the call and
is evicted at once.

The union of the probed lists, concatenated in ascending list order,
reproduces the global row order restricted to the union, so the union's
inverted lists are the global ones shifted by a per-list constant (a
monotone map).  Scoring then calls the HBM backend's own
``ivf._score_probed`` (partial probes: kernels 3 and 4) and
``ivf._full_scan`` (``nprobe >= nlist``, the union of every list being
the whole payload: kernels 1 and 2) over that union, so results equal
``backend="ivf"`` at equal probe sets, on every route and at every
budget.  The budget changes what crosses PCIe, never what comes back.

Mutations delegate to the HBM IVF implementation: add and compact
materialize the host mirrors as an ``IVFIndex`` on the device, run
``ivf._add`` / ``ivf._compact`` and host the result again (the paging
counters carry over).  Deletes only update the host bitmap: tombstones
are sliced per union from a device copy of the bitmap refreshed after
each delete, never read from the cached blocks, so the hot set stays
valid.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import scoring as S
from repro_torch.core.types import ASHPayload, ASHStats, CoarseCodes
from repro_torch.index import common as C
from repro_torch.index import ivf as IV
from repro_torch.index.api import (
    IVFBackend, _common_arrays, _next_id_meta, register_backend,
)
from repro_torch.serving.cache import ByteLRU

DEFAULT_HOT_BYTES = 64 << 20
ALIGN = 16  # bytes: each field of the staging buffer starts on a multiple

# host mirror columns, in block order; "raw" rides last when kept
_FIELDS = ("codes", "scale", "offset", "cluster", "res_norm", "ip_x_mu",
           "x_sq", "ids")


def pack_blocks(blocks, *, pin: bool):
    """Pack host tensors into one uint8 staging buffer.

    ``blocks``: a list of tuples of contiguous CPU tensors.  Returns
    (buffer, layout): each tensor's bytes start at a multiple of
    ``ALIGN``, and ``layout`` holds one tuple of (offset, dtype, shape)
    per block for :func:`unpack_blocks`.  ``pin`` allocates the buffer
    in pinned memory (for an asynchronous copy to a card)."""
    layout, off = [], 0
    for blk in blocks:
        entry = []
        for t in blk:
            entry.append((off, t.dtype, tuple(t.shape)))
            off += -(-t.numel() * t.element_size() // ALIGN) * ALIGN
        layout.append(tuple(entry))
    buf = torch.empty(off, dtype=torch.uint8, pin_memory=pin)
    for blk, entry in zip(blocks, layout):
        for t, (o, _, _) in zip(blk, entry):
            nb = t.numel() * t.element_size()
            if nb:
                buf[o:o + nb].copy_(t.contiguous().reshape(-1).view(
                    torch.uint8))
    return buf, layout


def unpack_blocks(buf: torch.Tensor, layout) -> list[tuple]:
    """Typed views of a packed buffer (on any device): one tuple of
    tensors per block, as :func:`pack_blocks` laid them out."""
    out = []
    for entry in layout:
        views = []
        for o, dtype, shape in entry:
            size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            views.append(buf[o:o + size].view(dtype).reshape(shape))
        out.append(tuple(views))
    return out


class TieredState:
    """Pinned host mirrors and the device hot set of one tiered index.

    ``counts``/``starts`` give each list's contiguous row range;
    ``invlists`` and ``live`` are exposed on the host so that the
    serving engine's IVF cost model (probe sets, live list sizes, nprobe
    clamping) works on this state unchanged.
    """

    def __init__(self):  # populated by from_ivf
        raise TypeError("use TieredState.from_ivf()")

    @classmethod
    def from_ivf(cls, index: IV.IVFIndex, hot_bytes: int,
                 carry: Optional["TieredState"] = None) -> "TieredState":
        """Host an ``IVFIndex``.  ``carry`` threads the lifetime cache
        and paging counters through a mutation's re-host so gauges stay
        monotonic (the hot set itself is dropped: a re-sort moves rows
        between lists)."""
        st = object.__new__(cls)
        st.metric = index.metric
        st.max_list_len = int(index.max_list_len)
        st.next_id = index.next_id
        st.hot_bytes = int(hot_bytes)
        st.model = index.model  # on the device, with the landmarks
        st.device = index.model.device
        st.coarse_mean = index.coarse.mean  # of the whole corpus
        st.b, st.d = index.payload.b, index.payload.d
        st.nlist = int(index.model.landmarks.shape[0])
        pin = st.device.type == "cuda"

        def host(t):
            t = t.detach().cpu().contiguous()
            return t.pin_memory() if pin else t

        for f in ASHPayload.ARRAY_FIELDS:
            setattr(st, f, host(getattr(index.payload, f)))
        for f in ("res_norm", "ip_x_mu", "x_sq"):
            setattr(st, f, host(getattr(index.stats, f)))
        st.ids = host(index.ids)
        st.raw = None if index.raw is None else host(index.raw)
        st.live = None if index.live is None else \
            index.live.detach().cpu().to(torch.bool)
        st.counts, st.starts = IV.list_geometry(st.cluster.numpy(), st.nlist)
        st._invlists = None
        st._invlists_dev = None
        st._live_dev = None
        st.cache = ByteLRU(st.hot_bytes)
        st.paged_rows = st.paged_bytes = st.transfers = 0
        st.total_bytes = sum(t.nbytes for t in st._columns())
        if carry is not None:
            for name in ("hits", "misses", "evictions"):
                setattr(st.cache, name, getattr(carry.cache, name))
            st.paged_rows = carry.paged_rows
            st.paged_bytes = carry.paged_bytes
            st.transfers = carry.transfers
        return st

    def _columns(self) -> tuple:
        cols = tuple(getattr(self, f) for f in _FIELDS)
        return cols if self.raw is None else cols + (self.raw,)

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def payload(self) -> ASHPayload:
        """The host mirrors as a payload (list-sorted rows)."""
        return ASHPayload(b=self.b, d=self.d, codes=self.codes,
                          scale=self.scale, offset=self.offset,
                          cluster=self.cluster)

    @property
    def stats(self) -> ASHStats:
        return ASHStats(res_norm=self.res_norm, ip_x_mu=self.ip_x_mu,
                        x_sq=self.x_sq)

    @property
    def invlists(self) -> np.ndarray:
        """Padded inverted lists of global rows, host numpy, derived
        lazily from the contiguous geometry."""
        if self._invlists is None:
            self._invlists = IV.build_invlists(self.counts, self.starts,
                                               self.max_list_len)
        return self._invlists

    @property
    def invlists_dev(self) -> torch.Tensor:
        """Device copy of :attr:`invlists`, which a union rebases."""
        if self._invlists_dev is None:
            self._invlists_dev = torch.as_tensor(self.invlists,
                                                 device=self.device)
        return self._invlists_dev

    @property
    def live_dev(self) -> Optional[torch.Tensor]:
        """Device copy of the tombstone bitmap, rebuilt after a delete."""
        if self.live is None:
            return None
        if self._live_dev is None:
            self._live_dev = self.live.to(self.device)
        return self._live_dev

    def materialize(self) -> IV.IVFIndex:
        """The same index on the device as an ``IVFIndex``: the mutation
        path runs the HBM implementation on it and hosts the result."""
        dev = self.device
        return IV.IVFIndex(
            metric=self.metric, max_list_len=self.max_list_len,
            model=self.model,
            payload=ASHPayload(b=self.b, d=self.d, **{
                f: getattr(self, f).to(dev)
                for f in ASHPayload.ARRAY_FIELDS}),
            ids=self.ids.to(dev), invlists=self.invlists_dev,
            raw=None if self.raw is None else self.raw.to(dev),
            stats=ASHStats(res_norm=self.res_norm.to(dev),
                           ip_x_mu=self.ip_x_mu.to(dev),
                           x_sq=self.x_sq.to(dev)),
            live=self.live_dev, next_id=self.next_id,
            coarse=CoarseCodes(mean=self.coarse_mean),
        )

    # -- the paging core ------------------------------------------------

    def _host_block(self, c: int) -> tuple:
        s = int(self.starts[c])
        e = s + int(self.counts[c])
        return tuple(t[s:e] for t in self._columns())

    def fetch_blocks(self, lists) -> dict:
        """Resolve every list in ``lists`` to its device block (a tuple
        in ``_FIELDS`` order, raw last): hits from the hot set, then ONE
        host-to-device copy of a pinned staging buffer for all misses."""
        out, miss = {}, []
        for c in lists:
            blk = self.cache.get(c)
            if blk is None:
                miss.append(c)
            else:
                out[c] = blk
        if not miss:
            return out
        buf, layout = pack_blocks([self._host_block(c) for c in miss],
                                  pin=self.device.type == "cuda")
        dev_buf = buf.to(self.device, non_blocking=True)
        for c, blk in zip(miss, unpack_blocks(dev_buf, layout)):
            out[c] = blk
            nbytes = sum(t.nbytes for t in blk)
            if nbytes <= self.cache.max_bytes:
                # its own memory: an eviction frees the list's bytes
                blk = tuple(t.clone() for t in blk)
            self.cache.put(c, blk)
            self.paged_rows += int(self.counts[c])
            self.paged_bytes += nbytes
        self.transfers += 1
        return out

    def union_index(self, lists) -> IV.IVFIndex:
        """An ``IVFIndex`` on the device over the union of ``lists``
        (ascending ids), inverted lists rebased to union rows (lists
        outside the union keep their global rows: a probe set is always
        inside the union built from it), the tombstone bitmap sliced
        from :attr:`live_dev`."""
        blocks = self.fetch_blocks(lists)
        cols = [torch.cat([blocks[c][i] for c in lists])
                for i in range(len(_FIELDS) + (self.raw is not None))]
        u = dict(zip(_FIELDS + ("raw",), cols))
        live = self.live_dev
        if live is not None:
            live = torch.cat([live[int(self.starts[c]):
                                   int(self.starts[c] + self.counts[c])]
                              for c in lists])
        inv = self.invlists_dev
        if len(lists) < self.nlist:
            idx = np.asarray(lists, dtype=np.int64)
            c_u = self.counts[idx]
            local = np.concatenate([[0], np.cumsum(c_u)[:-1]])
            delta = np.zeros(self.nlist, dtype=np.int32)
            delta[idx] = local - self.starts[idx]
            inv = torch.where(
                inv >= 0, inv + torch.as_tensor(delta, device=inv.device)[
                    :, None], -1)
        return IV.IVFIndex(
            metric=self.metric, max_list_len=self.max_list_len,
            model=self.model,
            payload=ASHPayload(b=self.b, d=self.d, codes=u["codes"],
                               scale=u["scale"], offset=u["offset"],
                               cluster=u["cluster"]),
            ids=u["ids"], invlists=inv, raw=u.get("raw"),
            stats=ASHStats(res_norm=u["res_norm"], ip_x_mu=u["ip_x_mu"],
                           x_sq=u["x_sq"]),
            live=live, next_id=None,
            coarse=CoarseCodes(mean=self.coarse_mean),
        )


@register_backend
class TieredIVFBackend:
    """Host-memory tiered inverted-file backend (see the module doc)."""

    name = "tiered_ivf"
    default_nprobe = IVFBackend.default_nprobe

    @staticmethod
    def build(gen, X, config, *, metric, hot_bytes: int = DEFAULT_HOT_BYTES,
              **opts):
        return TieredState.from_ivf(
            IV._build(gen, X, config, metric=metric, **opts), hot_bytes)

    @staticmethod
    def from_parts(model, payload, *, metric, raw=None,
                   hot_bytes: int = DEFAULT_HOT_BYTES):
        return TieredState.from_ivf(
            IVFBackend.from_parts(model, payload, metric=metric, raw=raw),
            hot_bytes)

    @staticmethod
    def resolve_nprobe(state, nprobe):
        """The HBM backend's default, clamped to the list count."""
        if nprobe is None:
            nprobe = TieredIVFBackend.default_nprobe
        return min(nprobe, state.nlist)

    # -- search ---------------------------------------------------------

    @staticmethod
    def search(state, queries, *, k, nprobe=None, rerank=0, **opts):
        prep = S.prepare_queries(state.model, queries)
        return TieredIVFBackend.search_prepped(
            state, prep, k=k, nprobe=nprobe, rerank=rerank, **opts)

    @staticmethod
    def search_prepped(state, prep, *, k, nprobe=None, rerank=0, **opts):
        nprobe = TieredIVFBackend.resolve_nprobe(state, nprobe)
        if nprobe >= state.nlist:
            # the union of every list is the whole list-sorted payload
            uidx = state.union_index(tuple(range(state.nlist)))
            return IV._full_scan(uidx, prep, k, rerank, **opts)
        probe = IV._probe_lists(state, prep, nprobe)
        return TieredIVFBackend._execute_probe(state, prep, probe, k, rerank,
                                               **opts)

    @staticmethod
    def _execute_probe(state, prep, probe, k, rerank, **opts):
        """Plan the union on the host, page it in, then score through
        the HBM backend's own gathered path."""
        pp = C.plan_paged_probe(probe.cpu().numpy(), state.counts,
                                state.starts, None, state.max_list_len)
        uidx = state.union_index(pp.union_lists)
        return IV._score_probed(uidx, prep, probe.to(state.device), k,
                                rerank, **opts)

    @staticmethod
    def probe_sets(state, prep, nprobe=None) -> np.ndarray:
        """Host-visible coarse assignment, as ``IVFBackend.probe_sets``."""
        nprobe = TieredIVFBackend.resolve_nprobe(state, nprobe)
        return IV._probe_lists(state, prep, nprobe).to(
            torch.int32).cpu().numpy()

    @staticmethod
    def search_probed(state, prep, probe, *, k, rerank=0, **opts):
        """Top-k over an explicit probed-list set (as
        ``IVFBackend.search_probed``)."""
        return TieredIVFBackend._execute_probe(
            state, prep, torch.as_tensor(np.asarray(probe),
                                         dtype=torch.int64), k, rerank,
            **opts)

    @staticmethod
    def list_sizes(state) -> np.ndarray:
        """Live rows per list, host numpy (nlist,) int64: segment sums
        over the contiguous geometry (``IVFBackend.list_sizes``)."""
        if state.live is None:
            return state.counts.astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(
            state.live.numpy().astype(np.int64))])
        ends = state.starts + state.counts
        return (csum[ends] - csum[state.starts]).astype(np.int64)

    # -- mutations (the HBM implementation) -----------------------------

    @staticmethod
    def add(state, X_new):
        return TieredState.from_ivf(IV._add(state.materialize(), X_new),
                                    state.hot_bytes, carry=state)

    @staticmethod
    def delete(state, del_ids):
        new_live, removed = C.mark_deleted(state.ids, state.live, del_ids,
                                           state.n)
        if removed == 0:
            return state, 0
        state.live = torch.from_numpy(new_live)
        state._live_dev = None
        return state, removed

    @staticmethod
    def compact(state):
        if state.live is None:
            return state
        return TieredState.from_ivf(IV._compact(state.materialize()),
                                    state.hot_bytes, carry=state)

    # -- introspection / persistence ------------------------------------

    @staticmethod
    def next_id_of(state):
        return C.effective_next_id(state.next_id, state.ids, state.n)

    @staticmethod
    def resident_mask(state) -> np.ndarray:
        """(nlist,) bool: the lists on the device right now (the engine
        bills the others at ``page_row_cost``)."""
        mask = np.zeros(state.nlist, dtype=bool)
        keys = list(state.cache.keys())
        if keys:
            mask[np.asarray(keys, dtype=np.int64)] = True
        return mask

    @staticmethod
    def tier_stats(state) -> dict:
        """Gauges of ``QueryEngine.stats.snapshot()["tier"]`` (lifetime
        counters, carried across mutations)."""
        cs = state.cache.stats()
        return {
            "hits": cs["hits"], "misses": cs["misses"],
            "hit_rate": round(cs["hit_rate"], 4),
            "evictions": cs["evictions"], "resident_lists": cs["entries"],
            "nlist": state.nlist, "resident_bytes": cs["nbytes"],
            "hot_bytes": state.hot_bytes, "total_bytes": state.total_bytes,
            "paged_rows": state.paged_rows,
            "paged_bytes": state.paged_bytes, "transfers": state.transfers,
        }

    @staticmethod
    def to_arrays(state):
        """``IVFBackend.to_arrays``'s layout (the host mirrors are the
        arrays), plus the hot-set budget in the meta."""
        arrays = {**_common_arrays(state), "ids": state.ids,
                  "invlists": torch.from_numpy(state.invlists)}
        for name in ("raw", "live"):
            if getattr(state, name) is not None:
                arrays[name] = getattr(state, name)
        return arrays, {"max_list_len": state.max_list_len,
                        "hot_bytes": state.hot_bytes, **_next_id_meta(state)}

    @staticmethod
    def from_arrays(arrays, meta, config, metric, *, hot_bytes=None):
        ivf = IVFBackend.from_arrays(arrays, meta, config, metric)
        if hot_bytes is None:
            hot_bytes = meta.get("hot_bytes", DEFAULT_HOT_BYTES)
        return TieredState.from_ivf(ivf, hot_bytes)
