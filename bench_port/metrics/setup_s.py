"""Seconds from the process's start to the window's start: imports, the
card, the builds on a checkout's first run, the pool, the warm-up."""


def read(rec):
    return rec.setup_s
