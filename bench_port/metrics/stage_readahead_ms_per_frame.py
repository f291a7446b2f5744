"""Host milliseconds a frame in the program's `stage_t["stage_readahead"]`
span (each staging chunk's read ahead, off the main thread: the wait for
the staging buffer's last upload is not in it), summed over the window's
decoders. None where the program has no such span (a program from before
the read ahead)."""


def read(rec):
    t = rec.stage_t
    if "stage_readahead" not in t:
        return None
    return 1e3 * t["stage_readahead"] / rec.frames
