"""Share of the window's frames whose coordinates the PCM frame driver took
from a sweep of its sample lines, narrow or full, and not from the locked
history: the program's counter `stage_t["count_pcm_coord_searches"]` over
the frames of the window's driver runs, summed over its decoders. None
where the program has no `pcm_coord_search` span, as one without the
sweep's span and counter has not."""


def read(rec):
    t = rec.stage_t
    if "pcm_coord_search" not in t:
        return None
    return t.get("count_pcm_coord_searches", 0.0) / rec.frames
