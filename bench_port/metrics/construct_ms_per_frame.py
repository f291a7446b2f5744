"""Host milliseconds a frame in the decoder constructors' own work: the
program's `stage_t["open"]` (readers, drivers, stitchers) and
`stage_t["setup"]` (the device state) spans inside `construct`, without
its staging and waits, summed over the window's decoders. None where the
program has no such spans."""


def read(rec):
    t = rec.stage_t
    if "open" not in t:
        return None
    return 1e3 * (t["open"] + t.get("setup", 0.0)) / rec.frames
