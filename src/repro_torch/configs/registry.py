"""The port's architectures, importable by the reference's ids
(``--arch <id>``; counterpart of ``repro.configs.registry``).

The five LM ids only: the recsys, sasrec and nequip families wait for
ROADMAP item 13c, and ``get`` names it for their ids.  The reference's
cells and sharding programs (``configs/base.py``) wait for item 15.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

from repro_torch.configs import (
    deepseek_7b, granite_moe_3b, kimi_k2_1t, llama32_3b, qwen2_72b,
)
from repro_torch.models import transformer
from repro_torch.train.trainer import TrainConfig


@dataclasses.dataclass
class Arch:
    arch_id: str
    family: str  # transformer (the only family the port holds)
    cfg: Any
    train_cfg: TrainConfig

    def loss_fn(self):
        """``loss_fn(params, batch)`` of the arch's family and config."""
        return functools.partial(transformer.loss_fn, cfg=self.cfg)


ARCHS = {
    arch_id: Arch(arch_id, "transformer", mod.CFG, mod.TRAIN_CFG)
    for arch_id, mod in (
        ("deepseek-7b", deepseek_7b), ("qwen2-72b", qwen2_72b),
        ("llama3.2-3b", llama32_3b), ("granite-moe-3b-a800m", granite_moe_3b),
        ("kimi-k2-1t-a32b", kimi_k2_1t),
    )
}
LATER = ("nequip", "sasrec", "dcn-v2", "fm", "autoint")  # item 13c


def get(arch_id: str) -> Arch:
    if arch_id in LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP item "
                       f"13c); available: {sorted(ARCHS)}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]
