"""The plain reference of the benchmark: ASH training, encoding, query
preparation, scoring, stable top-k, exact rerank and IVF probing in
plain PyTorch.

It is a frozen copy of the arithmetic of the system under test, kept
here so that no later change to the system can move the yardstick.  It
imports nothing of the system and takes nothing the system made: given
the same seeded rows and the same generator seed it works the index out
again.  Float32 products run with TF32 off (:func:`precision`), as the
configurations state; ``precision(tf32=True)`` is the control, the same
arithmetic one precision lower.
"""
from ashbench.reference.ash import (  # noqa: F401
    Model, Payload, encode, precision, train,
)
from ashbench.reference.search import (  # noqa: F401
    Shortlists, answers, exact_scores_of, prepare, probe_lists,
    shortlists, ash_scores_of,
)
