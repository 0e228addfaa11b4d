"""nequip [arXiv:2101.03164]: O(3)-equivariant interatomic potential
(the port's copy of ``repro.configs.nequip_cfg.CFG`` and its
``train_cfg`` as ``TRAIN_CFG``): Gaunt-coupled tensor products, message
passing as segment sums over edge lists; ASH is not applied (scalar
quantization of irrep features breaks equivariance)."""
from repro_torch.configs.base import gnn_cells
from repro_torch.models.nequip import NequIPConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = NequIPConfig(
    name="nequip", n_layers=5, channels=32, l_max=2, n_rbf=8,
    cutoff=5.0, n_species=16,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3))

CELLS = gnn_cells()

NOTES = (
    "E(3)-equivariant tensor products via numerically-exact Gaunt "
    "couplings; message passing = segment_sum over edge lists. "
    "ASH inapplicable (DESIGN.md §4). Graph shapes padded to x512 "
    "multiples with masks; d_feat shapes feed node_feats, molecule "
    "uses species embeddings."
)
