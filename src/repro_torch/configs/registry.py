"""The port's architectures, importable by the reference's ids
(``--arch <id>``; counterpart of ``repro.configs.registry`` and of the
reference's ``Arch`` in ``repro.configs.base``).

Ten ids in four families: the five LMs (``transformer``), ``sasrec``,
the recsys models ``dcn-v2``, ``fm`` and ``autoint`` (``recsys``) and
``nequip``.  ``Arch.model`` is the family's model module
(``init_params``, ``loss_fn``, ``make_trainable``); ``Arch.cells`` are
the reference's shape cells (``configs.base``), and
``make_cell_program`` builds a cell's sharded step for the dry-run
(``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

from repro_torch.configs import (
    autoint, base, dcn_v2, deepseek_7b, fm, granite_moe_3b, kimi_k2_1t,
    llama32_3b, nequip_cfg, qwen2_72b, sasrec_cfg,
)
from repro_torch.launch import sharding as SH
from repro_torch.launch.sharding import ShardingPolicy
from repro_torch.models import common as cm
from repro_torch.models import nequip, recsys, sasrec, transformer
from repro_torch.train.trainer import TrainConfig

FAMILIES = {"transformer": transformer, "sasrec": sasrec, "recsys": recsys,
            "nequip": nequip}


def _fake_scope():
    """The active fake-tensor mode's scope, or a new mode."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return base.fake_mode()


@dataclasses.dataclass
class Arch:
    arch_id: str
    family: str  # transformer | sasrec | recsys | nequip
    cfg: Any
    train_cfg: TrainConfig
    cells: dict = dataclasses.field(default_factory=dict)
    notes: str = ""
    # per-arch ShardingPolicy field overrides (size-dependent layout
    # tradeoffs): e.g. {"pin_ffn_hidden": False}
    policy_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def model(self):
        """The family's model module."""
        return FAMILIES[self.family]

    def cell(self, name: str) -> base.Cell:
        return self.cells[name]

    def loss_fn(self, constrain=cm.keep, **static):
        """``loss_fn(params, batch)`` of the arch's family and config,
        with the sharding hook ``constrain``, closed over ``static``
        (NequIP's ``n_graphs``, a Python int, as the reference's
        launcher closes over it)."""
        return functools.partial(self.model.loss_fn, cfg=self.cfg,
                                 constrain=constrain, **static)

    def abstract_params(self):
        """The parameters at full size as fake tensors (no storage), in
        the active fake mode or a new one."""
        with _fake_scope():
            return base.init_params(self)

    def abstract_state(self):
        """The ``TrainState`` at full size: fake parameters and moments,
        the counters real CPU tensors."""
        from repro_torch.train.trainer import init_state

        with _fake_scope():
            return init_state(0, base.init_params(self), self.train_cfg)

    def param_rules(self, mesh, pol: ShardingPolicy):
        if self.family == "transformer":
            return SH.transformer_param_rules(mesh, pol)
        if self.family == "nequip":
            return SH.nequip_param_rules(mesh, pol)
        return SH.recsys_param_rules(mesh, pol)

    def policy(self, pol: ShardingPolicy) -> ShardingPolicy:
        """``pol`` with this arch's overrides."""
        if self.policy_overrides:
            return dataclasses.replace(pol, **self.policy_overrides)
        return pol

    def make_cell_program(self, cell_name: str, mesh, pol: ShardingPolicy):
        """(fn, args) of a cell on ``mesh`` (a ``launch.mesh.Mesh`` with
        its DeviceMesh): ``args`` fake DTensors sharded by the rules,
        built in the fake mode ``fn.fake_mode`` in which ``fn(*args)``
        is traced; on real tensors ``fn`` is the cell's step."""
        cell = self.cells[cell_name]
        pol = self.policy(pol)
        constrain = SH.make_constrain(mesh, pol,
                                      param_rules=self.param_rules(mesh, pol))
        mode = base.fake_mode()
        with mode:
            fn, args = base.CELL_BUILDERS[(self.family, cell.kind)](
                self, cell, mesh, pol, constrain)
        fn.fake_mode = mode
        return fn, args


ARCHS = {
    arch_id: Arch(arch_id, family, mod.CFG, mod.TRAIN_CFG, mod.CELLS,
                  mod.NOTES, getattr(mod, "POLICY_OVERRIDES", {}))
    for arch_id, family, mod in (
        ("deepseek-7b", "transformer", deepseek_7b),
        ("qwen2-72b", "transformer", qwen2_72b),
        ("llama3.2-3b", "transformer", llama32_3b),
        ("granite-moe-3b-a800m", "transformer", granite_moe_3b),
        ("kimi-k2-1t-a32b", "transformer", kimi_k2_1t),
        ("nequip", "nequip", nequip_cfg),
        ("sasrec", "sasrec", sasrec_cfg),
        ("dcn-v2", "recsys", dcn_v2),
        ("fm", "recsys", fm),
        ("autoint", "recsys", autoint),
    )
}


def get(arch_id: str) -> Arch:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = False):
    """Yield (arch, cell) for the official dry-run matrix."""
    for arch in ARCHS.values():
        for cell in arch.cells.values():
            if cell.skip and not include_skipped:
                continue
            yield arch, cell
