"""Share of the window's frames whose failed lines the PCM frame driver
refined: the program's counter `stage_t["count_pcm_refined_frames"]` over
the frames of the window's driver runs, summed over its decoders (a
counter never added to reads 0). None where the program has no `pcm_agc`
span, as one without the PCM path's spans and counters has not."""


def read(rec):
    t = rec.stage_t
    if "pcm_agc" not in t:
        return None
    return t.get("count_pcm_refined_frames", 0.0) / rec.frames
