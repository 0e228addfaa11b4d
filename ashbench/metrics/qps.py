"""Query rows whose top-k ids reached the host in the window, over the
window's seconds (batch cells; host clock)."""


def read(rec):
    if rec.kind != "batch" or rec.window_s <= 0:
        return None
    return rec.rows / rec.window_s
