"""Host milliseconds a frame in the program's `stage_t["stage_upload"]`
span (each staging chunk's copy to the card from pageable memory, which
waits for the rounds queued before it, inside `stage_hbm`), summed over
the window's decoders. None where the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["stage_upload"] / rec.frames if "stage_upload" in t \
        else None
