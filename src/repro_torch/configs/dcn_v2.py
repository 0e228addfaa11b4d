"""dcn-v2 [arXiv:2008.13535]: deep & cross network v2 (the port's copy
of ``repro.configs.dcn_v2.CFG`` and its ``train_cfg`` as
``TRAIN_CFG``): 26 x 1,048,576-row tables in one folded table."""
from repro_torch.configs.base import recsys_cells
from repro_torch.models.recsys import RecSysConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = RecSysConfig(
    name="dcn-v2", kind="dcn_v2", n_dense=13, n_sparse=26,
    embed_dim=16, vocab_per_field=1_048_576, n_cross_layers=3,
    mlp_dims=(1024, 1024, 512),
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3))

CELLS = recsys_cells()

NOTES = "26 x 1M-row embedding tables row-sharded over all axes."
