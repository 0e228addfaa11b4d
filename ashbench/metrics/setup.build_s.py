"""The harness's span around ``AshIndex.build``: training, encoding and
the backend's assembly (host clock)."""


def read(rec):
    return rec.spans.get("build")
