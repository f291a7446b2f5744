"""Host milliseconds a frame in the program's `stage_t["audio"]` and
`stage_t["wav"]` spans, summed over the window's decoders."""


def read(rec):
    t = rec.stage_t
    return 1e3 * (t.get("audio", 0.0) + t.get("wav", 0.0)) / rec.frames
