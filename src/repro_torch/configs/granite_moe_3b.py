"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base]: MoE,
40 experts top-8.

The port's copy of ``repro.configs.granite_moe_3b.CFG`` (its fields,
``remat`` included) and of its ``train_cfg`` as ``TRAIN_CFG``;
d_head = 64, G = 3 query heads per KV head.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.configs.base import lm_cells
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = TransformerConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155, qkv_bias=False,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, group_size=4096),
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    q_chunk=2048,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=3e-4), microbatches=4)

CELLS = lm_cells(full_attention=True)

POLICY_OVERRIDES = {
    # <10B models: replicating FFN/attention weights is cheaper than
    # gathering activations (the reference's measurement on its TPU mesh)
    "pin_ffn_hidden": False, "pin_attn_boundary": False,
}

NOTES = (
    "40 experts top-8; E=40 not divisible by model=16 so experts "
    "shard over pod and expert-FFN width over data (see sharding "
    "rules). vocab 49155 is odd -> embed/lm_head replicated."
)


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
