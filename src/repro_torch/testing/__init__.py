"""Test-support machinery importable from production code.

Only :mod:`repro_torch.testing.faults` lives here: fault-injection
points that cost one dict lookup unless a test arms them.
"""
from repro_torch.testing import faults

__all__ = ["faults"]
