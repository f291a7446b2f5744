"""Host milliseconds a frame in the program's `stage_t["pcm_coord_search"]`
span (the PCM frame driver's coordinate sweeps of its sample lines, inside
`pcm_agc`), summed over the window's decoders. None where the program has
no such span."""


def read(rec):
    t = rec.stage_t
    if "pcm_coord_search" not in t:
        return None
    return 1e3 * t["pcm_coord_search"] / rec.frames
