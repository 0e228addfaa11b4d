"""Live candidates of the probed lists over the candidate-table entries
(queries x nprobe x the longest list), from ``list_sizes()`` and
``probe_sets()`` over the batch pool, in %."""


def read(rec):
    if rec.kind != "batch" or rec.probes is None or rec.list_sizes is None:
        return None
    sizes = rec.list_sizes
    entries = rec.probes.size * float(sizes.max())
    return 100.0 * float(sizes[rec.probes].sum()) / entries
