"""The port's architectures, importable by the reference's ids
(``--arch <id>``; counterpart of ``repro.configs.registry``).

Ten ids in four families: the five LMs (``transformer``), ``sasrec``,
the recsys models ``dcn-v2``, ``fm`` and ``autoint`` (``recsys``) and
``nequip``.  ``Arch.model`` is the family's model module
(``init_params``, ``loss_fn``, ``make_trainable``).
The reference's cells and sharding programs (``configs/base.py``) wait
for ROADMAP item 15.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

from repro_torch.configs import (
    autoint, dcn_v2, deepseek_7b, fm, granite_moe_3b, kimi_k2_1t,
    llama32_3b, nequip_cfg, qwen2_72b, sasrec_cfg,
)
from repro_torch.models import nequip, recsys, sasrec, transformer
from repro_torch.train.trainer import TrainConfig

FAMILIES = {"transformer": transformer, "sasrec": sasrec, "recsys": recsys,
            "nequip": nequip}


@dataclasses.dataclass
class Arch:
    arch_id: str
    family: str  # transformer | sasrec | recsys | nequip
    cfg: Any
    train_cfg: TrainConfig

    @property
    def model(self):
        """The family's model module."""
        return FAMILIES[self.family]

    def loss_fn(self, **static):
        """``loss_fn(params, batch)`` of the arch's family and config,
        closed over ``static`` (NequIP's ``n_graphs``, a Python int, as
        the reference's launcher closes over it)."""
        return functools.partial(self.model.loss_fn, cfg=self.cfg, **static)


ARCHS = {
    arch_id: Arch(arch_id, family, mod.CFG, mod.TRAIN_CFG)
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
