"""Host milliseconds a frame in the program's `stage_t["stage_split"]` span
(each staging chunk's split into fields, inside `stage_hbm`), summed over
the window's decoders. None where the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["stage_split"] / rec.frames if "stage_split" in t \
        else None
