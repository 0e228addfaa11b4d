"""Query rows a fused engine call over the window:
``EngineStats.snapshot()`` rows over batches (online cells)."""


def read(rec):
    c = rec.counters
    if rec.kind != "open_loop" or not c.get("batches"):
        return None
    return c["rows"] / c["batches"]
