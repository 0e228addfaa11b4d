"""qwen2-72b [arXiv:2407.10671]: dense, GQA kv=8, QKV bias.

The port's copy of ``repro.configs.qwen2_72b.CFG`` (its fields,
``remat`` included) and of its ``train_cfg`` as ``TRAIN_CFG``.  Its
72 B parameters do not fit one 80 GB card: a config only.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.configs.base import lm_cells
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = TransformerConfig(
    name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    q_chunk=2048,
)

TRAIN_CFG = TrainConfig(
    opt=OptConfig(name="adamw", lr=2e-4, moment_dtype=torch.bfloat16),
    microbatches=8, grad_accum_dtype=torch.float32,
)

CELLS = lm_cells(full_attention=True)

NOTES = "72B dense: FSDP + TP; bf16 Adam moments to fit the TPU's HBM."


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
