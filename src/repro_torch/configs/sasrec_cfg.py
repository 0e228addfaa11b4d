"""sasrec [arXiv:1808.09781]: self-attentive sequential recsys.

The port's copy of ``repro.configs.sasrec_cfg.CFG`` and of its
``train_cfg`` as ``TRAIN_CFG``.  ``ASH_BITS`` and ``ASH_REDUCE`` are the
extra ``retrieval_cand_ash`` cell's numbers: candidates ASH-encoded at
b = 4, d = embed_dim / 2 (~12.5x smaller than the fp32 table) and
scored asymmetrically (``serving.retrieval.sasrec_retrieve``).
"""
from repro_torch.models.sasrec import SASRecConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = SASRecConfig(
    name="sasrec", n_items=1_048_576, embed_dim=50, n_blocks=2,
    n_heads=1, seq_len=50, n_neg=128,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3))

ASH_BITS = 4  # retrieval_cand_ash: b
ASH_REDUCE = 2  # retrieval_cand_ash: d = embed_dim // ASH_REDUCE
