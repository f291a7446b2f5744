"""Host milliseconds a frame in the program's `stage_t["stage_read"]` span
(the y4m read of each staging chunk, inside `stage_hbm`), summed over the
window's decoders. None where the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["stage_read"] / rec.frames if "stage_read" in t else None
