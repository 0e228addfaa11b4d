"""kimi-k2-1t-a32b [arXiv:2501.kimi2]: trillion-param MoE, 384e top-8.

The port's copy of ``repro.configs.kimi_k2_1t.CFG`` (its fields,
``remat`` included) and of its ``train_cfg`` as ``TRAIN_CFG``.  Its
1 T parameters do not fit one 80 GB card: a config only.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.configs.base import lm_cells
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = TransformerConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, vocab=163840, qkv_bias=False,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, group_size=4096),
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    q_chunk=2048,
)

TRAIN_CFG = TrainConfig(
    # Adafactor (factored 2nd moment, no momentum), bf16 moments and
    # gradient accumulators, 16 microbatches: the reference's 1T budget
    opt=OptConfig(name="adafactor", lr=1e-4, b1=0.0,
                  moment_dtype=torch.bfloat16),
    microbatches=16, grad_accum_dtype=torch.bfloat16,
)

CELLS = lm_cells(full_attention=True)

NOTES = (
    "1T-param MoE: experts sharded E/model x Fe/data x D/pod; "
    "memory budget discussed in EXPERIMENTS.md §Dry-run."
)


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
