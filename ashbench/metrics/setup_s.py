"""Process start to the start of the measured window: data, build,
kernel build or load, warm-up (host clock)."""


def read(rec):
    return rec.setup_s
