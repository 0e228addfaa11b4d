"""1 - the union of the device's kernel, copy and memset intervals over
the traced stretch of an online cell, in %."""


def read(rec):
    if rec.kind != "open_loop" or rec.trace is None:
        return None
    return 100.0 * rec.trace.idle_share
