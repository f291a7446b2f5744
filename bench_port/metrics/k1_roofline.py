"""K1's share of its roofline, in %: the least time the traced window's
K1 launches could take (the bytes its rounds' frames need, read once, at
3.35 TB/s, the H100 SXM's published HBM rate) over K1's device time in
the trace. Left out where the trace lost rows or where K1 ran other than
once a round (a sweep or a fallback, whose bytes this does not count)."""
from bench_port import cells

HBM_BYTES_PER_S = 3.35e12


def read(rec):
    t = rec.trace
    if t is None or t["lost"] or not t["k1_s"]:
        return None
    if not t["k1_launches"] == t["rounds"] == len(t["round_frames"]):
        return None
    cfg = rec.cell.config
    fmt = cells.format_module(cfg["format"])
    need = sum(fmt.k1_round_bytes(cfg, f) for f in t["round_frames"])
    return 100.0 * need / HBM_BYTES_PER_S / t["k1_s"]
