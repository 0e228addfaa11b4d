"""sasrec [arXiv:1808.09781]: self-attentive sequential recsys.

The port's copy of ``repro.configs.sasrec_cfg.CFG``, of its
``train_cfg`` as ``TRAIN_CFG`` and of its cells: the recsys cells and
the extra ``retrieval_cand_ash``, candidates ASH-encoded at
b = ``ash_bits``, d = embed_dim / ``ash_reduce`` (~12.5x smaller than
the fp32 table) and scored asymmetrically
(``serving.retrieval.sasrec_retrieve``).
"""
from repro_torch.configs.base import Cell, recsys_cells
from repro_torch.models.sasrec import SASRecConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = SASRecConfig(
    name="sasrec", n_items=1_048_576, embed_dim=50, n_blocks=2,
    n_heads=1, seq_len=50, n_neg=128,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3))

CELLS = recsys_cells()
# EXTRA cell (beyond the 40): the paper's technique as the serving
# optimization — candidates ASH-encoded (b=4, d=e/2, ~12.5x smaller
# payload), scored asymmetrically.
CELLS["retrieval_cand_ash"] = Cell(
    "retrieval_cand_ash", "retrieval",
    {"batch": 1, "n_candidates": 1_000_000, "ash_bits": 4,
     "ash_reduce": 2},
    skip="extra cell (paper-technique-optimized retrieval variant)",
)

NOTES = (
    "Next-item retrieval == MIPS over item embeddings: the ASH "
    "technique's natural serving integration (serving.retrieval)."
)
