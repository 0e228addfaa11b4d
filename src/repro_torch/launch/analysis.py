"""Per-card cost of a cell by tracing its program on fake DTensors
(counterpart of ``repro.launch.analysis``).

:func:`trace` runs ``fn(*args)`` of ``Arch.make_cell_program`` inside
its fake mode: every tensor is a fake tensor (shapes, no storage), and
the arguments are DTensors over the mesh's fake process group.  A
dispatch mode stands aside for each DTensor op (it returns
``NotImplemented``), so DTensor redistributes and runs the op on its
local shards, and the mode sees those local ops: what one card runs.
A mode outside DTensor would see only global shapes.  Per card it
counts

* FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) on the local operands' shapes;
* HBM bytes: every input read and every output written by each
  non-view op, with no fusion, so an upper estimate;
* collectives: each functional collective DTensor issues, its output
  bytes by kind and by mesh axis (``roofline.CollectiveStats``), the
  counts cross-checked against ``CommDebugMode``;
* the peak of live bytes: the local storages alive at once (arguments
  included), from weak references to each op's outputs.

The port runs a model's layers as a Python loop, so a trace counts every
layer and the reference's scan correction is not needed.  Its probe
algebra stays as a check: F(L) = e + L·l from traces at L = 1 and 2
must give the full-depth count (:func:`probe_check`).

Three patches of DTensor internals hold during a trace
(:func:`_trace_patches`): DTensor infers an op's global output shape
by running the op once on global-shape fake tensors, which the tracer
must not count (it is paused); it computes the shard sizes and offsets
of a strided shard (a reshape of a sharded dim) from index tensors it
reads back, which runs outside the fake mode (and unseen by the
tracer); and it compares the masks of a vocabulary-sharded gather by
value, which fake tensors cannot do (the check is set aside: both masks
are the same gather's).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import mesh_size


@dataclasses.dataclass
class CostVec:
    flops: float
    hbm_bytes: float
    coll_bytes: float

    def __add__(self, o):
        return CostVec(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
                       self.coll_bytes + o.coll_bytes)

    def __sub__(self, o):
        return CostVec(self.flops - o.flops, self.hbm_bytes - o.hbm_bytes,
                       self.coll_bytes - o.coll_bytes)

    def __mul__(self, s):
        return CostVec(self.flops * s, self.hbm_bytes * s,
                       self.coll_bytes * s)

    __rmul__ = __mul__


_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no data: allocations and metadata
_FREE = {"empty", "empty_strided", "empty_like", "detach", "device",
         "lift_fresh", "_to_copy_noop", "set_", "resize_", "alias"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tracer(TorchDispatchMode):
    """Counts the local ops of a DTensor program (see the module doc)."""

    def __init__(self, group_axes: dict):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.group_axes = group_axes
        self.flops = 0.0
        self.hbm = 0.0
        self.coll = RL.CollectiveStats({}, {}, {})
        self.live: dict = {}  # storage key -> (weak ref, bytes)
        self.live_bound = 0  # sum of registered bytes, some maybe freed
        self.peak = 0
        self.paused = 0  # > 0 while DTensor infers global shapes

    # -- live bytes ------------------------------------------------------
    def _sweep(self):
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bound -= self.live.pop(k)[1]

    def register(self, t: torch.Tensor):
        from torch.multiprocessing.reductions import StorageWeakRef

        st = t.untyped_storage()
        key = st._cdata
        if key in self.live and not self.live[key][0].expired():
            return
        if key in self.live:
            self.live_bound -= self.live.pop(key)[1]
        self.live[key] = (StorageWeakRef(st), st.nbytes())
        self.live_bound += st.nbytes()
        if self.live_bound > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live_bound)

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors(out))
                c = self.coll
                c.bytes_by_kind[kind] = c.bytes_by_kind.get(kind, 0) + b
                c.count_by_kind[kind] = c.count_by_kind.get(kind, 0) + 1
                group = args[-1] if isinstance(args[-1], str) else None
                axis = self.group_axes.get(group, "?")
                c.bytes_by_axis[axis] = c.bytes_by_axis.get(axis, 0) + b
        elif not func.is_view and name not in _FREE and ns != "prim":
            f = self.registry.get(func._overloadpacket)
            if f is not None:
                self.flops += f(*args, **kwargs, out_val=out)
            self.hbm += (sum(_nbytes(t) for t in _tensors(args))
                         + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self.register(t)
        return out


@contextlib.contextmanager
def _trace_patches(tracer: _Tracer):
    import importlib

    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def find(module, name):
        try:
            return getattr(importlib.import_module(module), name)
        except (ImportError, AttributeError):
            return None  # another torch: no such internal to patch

    MB = find("torch.distributed.tensor._ops._mask_buffer", "MaskBuffer")
    ShardingPropagator = find("torch.distributed.tensor._sharding_prop",
                              "ShardingPropagator")
    _StridedShard = find("torch.distributed.tensor.placement_types",
                         "_StridedShard")

    def paused(fn, real=False):
        if isinstance(fn, (staticmethod, classmethod)):
            return type(fn)(paused(fn.__func__, real))

        def run(*args, **kwargs):
            tracer.paused += 1
            try:
                if real:
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                tracer.paused -= 1
        return run

    def materialize(self, mask):
        if self.refcount == 0:
            self.data = mask
        self.refcount += 1

    patches = [(owner, name, wrap(owner.__dict__[name]))
               for owner, name, wrap in (
                   (MB, "materialize_mask", lambda _: materialize),
                   (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                    paused),
                   (_StridedShard, "local_shard_size_and_offset",
                    lambda fn: paused(fn, real=True)))
               if owner is not None and name in owner.__dict__]
    saved = [(owner, name, owner.__dict__[name])
             for owner, name, _ in patches]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def arg_leaves(x) -> list:
    """The tensors of a cell program's arguments, each once: a train
    state's leaves, a transformer's reference leaves, tree leaves."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as TT
    from repro_torch.train.trainer import TrainState

    if isinstance(x, TrainState):
        return [t for _, t in base.state_items(x)]
    if isinstance(x, TT.Transformer):
        return [t for _, t in SH.tree_items(TT.stacked_tree(x))]
    if isinstance(x, (dict, list, tuple)):
        vals = x.values() if isinstance(x, dict) else x
        return [t for v in vals for t in arg_leaves(v)]
    return [x]


def argument_bytes(args) -> int:
    """Per-card bytes of the arguments, exact from their specs."""
    return sum(SH.local_nbytes(t) for t in arg_leaves(list(args)))


@dataclasses.dataclass
class Trace:
    cost: CostVec
    coll: RL.CollectiveStats
    argument_bytes: int
    arg_bytes: list  # per positional argument
    output_bytes: int
    peak_bytes: int
    seconds: float


def _group_axes(mesh) -> dict:
    dm = mesh.device_mesh
    return {dm.get_group(a).group_name: a for a in mesh.axis_names}


def trace(fn, args, mesh) -> Trace:
    """Trace ``fn(*args)`` (``Arch.make_cell_program``) on ``mesh``."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    t0 = time.time()
    tracer = _Tracer(_group_axes(mesh))
    with fn.fake_mode:
        for t in arg_leaves(list(args)):
            tracer.register(getattr(t, "_local_tensor", t))
        with _trace_patches(tracer), CommDebugMode() as comm, tracer, \
                implicit_replication():
            out = fn(*args)
        counted = {str(k).split(".")[-1]: v
                   for k, v in comm.get_comm_counts().items()}
        tracer._sweep()
        out_bytes = sum(SH.local_nbytes(t) for t in _tensors(out))
    seen = {}
    for op, kind in _COLLECTIVE_KIND.items():
        if op in counted:
            seen[kind] = seen.get(kind, 0) + counted[op]
    if seen != {k: v for k, v in tracer.coll.count_by_kind.items() if v}:
        raise RuntimeError(f"collective counts disagree: CommDebugMode "
                           f"{seen}, trace {tracer.coll.count_by_kind}")
    return Trace(CostVec(tracer.flops, tracer.hbm, tracer.coll.total_bytes),
                 tracer.coll, argument_bytes(args),
                 [argument_bytes([a]) for a in args], out_bytes,
                 tracer.peak, time.time() - t0)


def trace_cell(arch, cell, mesh, pol) -> Trace:
    fn, args = arch.make_cell_program(cell.name, mesh, pol)
    return trace(fn, args, mesh)


def corrected_roofline(arch, cell, mesh, pol,
                       tr: Optional[Trace] = None) -> RL.Roofline:
    """The per-card roofline of a cell from its full-depth trace ``tr``
    (traced here when not given)."""
    if tr is None:
        tr = trace_cell(arch, cell, mesh, pol)
    chips = mesh_size(mesh)
    mf = RL.model_flops_for(arch, cell)
    return RL.Roofline(
        flops=tr.cost.flops, hbm_bytes=tr.cost.hbm_bytes,
        collective_bytes=tr.cost.coll_bytes, n_chips=chips,
        model_flops=(mf / chips if mf is not None else None),
        axis_bytes=dict(tr.coll.bytes_by_axis))


def _at_depth(arch, n_layers: int):
    return dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=n_layers))


def probe_check(arch, cell, mesh, pol,
                full: Optional[Trace] = None) -> dict:
    """The reference's probe algebra on an LM cell: traces at L = 1 and
    2 give e and l of F(L) = e + L·l; returns the full-depth FLOPs, the
    algebra's prediction and their relative difference."""
    f1 = trace_cell(_at_depth(arch, 1), cell, mesh, pol).cost
    f2 = trace_cell(_at_depth(arch, 2), cell, mesh, pol).cost
    layer = f2 - f1
    fixed = f1 - layer
    pred = fixed + arch.cfg.n_layers * layer
    if full is None:
        full = trace_cell(arch, cell, mesh, pol)
    got = full.cost.flops
    return {"probe_flops": pred.flops, "flops": got,
            "probe_rel_err": abs(pred.flops - got) / max(abs(got), 1.0)}
