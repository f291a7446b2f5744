"""Host milliseconds a frame in the program's `stage_t["wait"]` spans,
every place the host blocks on the card (round buffers and samples read
back, lazy word fetches, staging awaited), summed over the window's
decoders. None where the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["wait"] / rec.frames if "wait" in t else None
