"""Baseline quantizers the paper compares against (Sections 4-5).

Counterpart of ``repro.baselines``, with the same functional API:

    state            = <method>.train(gen, X, **cfg, device="cuda")
    encoded          = <method>.encode(state, X)
    scores (m, n)    = <method>.score(state, encoded, Q)
    state.bits_per_vector  -> payload size for iso-compression sweeps

States are dataclasses of tensors with the reference's field names;
each module's ``from_numpy`` builds one from the reference state's
arrays.  Everything is plain PyTorch: the reference's baselines reach
no Pallas kernel (their LUT gathers and products are plain jnp).
"""
from repro_torch.baselines import eden, leanvec, lopq, pq, rabitq

__all__ = ["pq", "lopq", "eden", "leanvec", "rabitq"]
