"""1 - (union of the CUDA kernel and copy rows' time) / the wall of the
same traced window. Left out where the trace lost rows."""


def read(rec):
    t = rec.trace
    if t is None or t["lost"] or not t["window_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
