"""autoint [arXiv:1810.11921]: self-attentive feature interaction, 3
layers of 2-head attention over 39 field embeddings (the port's copy of
``repro.configs.autoint.CFG`` and its ``train_cfg`` as ``TRAIN_CFG``)."""
from repro_torch.configs.base import recsys_cells
from repro_torch.models.recsys import RecSysConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = RecSysConfig(
    name="autoint", kind="autoint", n_dense=0, n_sparse=39,
    embed_dim=16, vocab_per_field=1_048_576, n_attn_layers=3,
    n_attn_heads=2, d_attn=32,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3))

CELLS = recsys_cells()

NOTES = "3-layer 2-head self-attention over 39 field embeddings."
