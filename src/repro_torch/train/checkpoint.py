"""Versioned, atomically committed checkpointing and restart
(counterpart of ``repro.train.checkpoint``), in the reference's on-disk
format, so either package restores the other's training state.

A save writes a ``.tmp_step_XXXXXXXXXX`` staging directory: one ``.npy``
file a leaf (bfloat16 stored as its uint16 view) and ``manifest.json``
with ``step``, ``extra`` and ``arrays`` (file, dtype, shape by leaf
name); renames it to ``step_XXXXXXXXXX``; writes the ``COMMIT`` marker
and keeps the last ``keep_n`` commits.  A directory without the marker
is invisible, so a crash mid-write never corrupts the latest
checkpoint.  The data-iterator cursor and the seed go in ``extra``, so
a restart resumes the exact batch stream (kill -> restore -> a bitwise
identical loss trajectory).

Leaf names are the reference's (``_flatten_with_paths``: a NamedTuple
field ``.name``, a dict key ``['key']``, a list index ``[i]``, joined by
``/``), over the reference's tree: a trainable ``Transformer`` is saved
as its stacked tree (``models.transformer.make_trainable``).  ``save``
copies every tensor to host memory before it returns (the optimizer
updates the live tensors in place); only the file writing runs on the
background thread.  ``restore`` copies each leaf into the template's
tensor in place (dtype and shape must match) and returns the template's
structure; the reference's sharding argument has no counterpart here.

Optimizer and error-feedback states (``AdamState``, ``AdafactorState``,
``MuonState``, ``EFState``: NamedTuples of the same fields in both
packages) also cross in memory, leaf by leaf, with ``state_to_numpy``
and ``state_from_numpy``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.convert import (tensor_from_numpy, tree_from_numpy,
                                        tree_to_numpy)
from repro_torch.train import compression, optim


def state_to_numpy(state):
    """An optimizer or error-feedback state (a NamedTuple of tensors and
    trees of tensors) with numpy leaves, the same class."""
    return type(state)(*(tree_to_numpy(x) for x in state))


def state_from_numpy(state, *, device="cuda"):
    """The port's optimizer or error-feedback state from either
    package's state with numpy (or array) leaves, matched by class name;
    ``step`` on the CPU, the buffers on ``device``."""
    cls = getattr(optim, type(state).__name__, None) or getattr(
        compression, type(state).__name__)
    dev = resolve_device(device)
    return cls(**{
        f: (tensor_from_numpy(np.asarray(x)) if f == "step"
            else tree_from_numpy(x, dev))
        for f, x in zip(cls._fields, state)})


def _children(tree):
    """(name part, child) pairs of a node, or None for a leaf."""
    if isinstance(tree, torch.nn.Module):
        if tree.tree is None:
            raise ValueError("a module is saved as its training tree; "
                             "call models.transformer.make_trainable")
        tree = tree.tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{leaf name: leaf} in the reference's names and order; None nodes
    have no leaves."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for part, child in kids:
        out.update(_flatten_with_paths(
            child, f"{prefix}/{part}" if prefix else part))
    return out


def _to_host(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


def _to_numpy(t: torch.Tensor):
    """(array to write, manifest dtype); bfloat16 as its uint16 view."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Snapshot to host memory synchronously, write in background."""
        host = {name: _to_host(x)
                for name, x in _flatten_with_paths(state).items()}
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time

        def _write():
            self._write_sync(step, host, extra or {})

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write_sync(self, step, host, extra):
        tmp = os.path.join(self.dir, f".tmp_step_{step:010d}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        for name, t in host.items():
            fname = name.replace("/", "__") + ".npy"
            arr, dtype = _to_numpy(t)
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][name] = {"file": fname, "dtype": dtype,
                                        "shape": list(arr.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # atomic commit
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write(str(time.time()))
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMIT")):
                out.append(int(d.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, template: Any, step: Optional[int] = None):
        """Restore the checkpoint of ``step`` (default: the latest commit)
        into ``template``'s tensors, in place.  Returns (template,
        extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = manifest["arrays"]
        for name, dst in _flatten_with_paths(template).items():
            meta = arrays[name]
            src = _from_numpy(np.load(os.path.join(final, meta["file"])),
                              meta["dtype"])
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"{name}: checkpoint {src.dtype} "
                                 f"{tuple(src.shape)}, template {dst.dtype} "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        return template, manifest["extra"]
