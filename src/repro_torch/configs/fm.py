"""fm [Rendle ICDM'10]: factorization machine, O(nk) sum-square trick
(the port's copy of ``repro.configs.fm.CFG`` and its ``train_cfg`` as
``TRAIN_CFG``)."""
from repro_torch.configs.base import recsys_cells
from repro_torch.models.recsys import RecSysConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = RecSysConfig(
    name="fm", kind="fm", n_dense=0, n_sparse=39, embed_dim=10,
    vocab_per_field=1_048_576,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3))

CELLS = recsys_cells()

NOTES = "pairwise interactions via 0.5((sum v)^2 - sum v^2)."
