"""Host milliseconds a frame in the program's `stage_t["stage_hbm"]` span,
summed over the window's decoders."""


def read(rec):
    return 1e3 * rec.stage_t.get("stage_hbm", 0.0) / rec.frames
