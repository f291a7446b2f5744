"""Video frames of every capture decoded to a closed WAV in the window,
over the window's wall (its start to the last driver run's end)."""
from bench_port import stats


def read(rec):
    return stats.rate(rec.frames, rec.window_s)
