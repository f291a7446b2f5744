"""Host milliseconds a frame in the program's `stage_t["pcm_agc"]` span
(the PCM frame driver's AGC and coordinate search over each round's
prescan rows, inside `prescan`), summed over the window's decoders. None
where the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["pcm_agc"] / rec.frames if "pcm_agc" in t else None
