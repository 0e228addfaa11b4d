"""Bound time of the traced batch calls' work (``work/<config>.py``)
over the device's busy time in the traced stretch, in %."""


def read(rec):
    if rec.kind != "batch" or rec.trace is None or rec.traced_work is None \
            or rec.trace.busy_s <= 0:
        return None
    return 100.0 * rec.traced_work.bound_s() / rec.trace.busy_s
