"""Host milliseconds a frame in the program's `stage_t["pcm_refine"]` spans
(the fetch of the frames with failed lines, their per-line refinement,
the Bit Picker and the CRC re-check of every frame, inside `finalize`),
summed over the window's decoders. On clean traffic no frame is refined,
and this reads the Bit Picker and the per-frame CRC re-check alone. None
where the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["pcm_refine"] / rec.frames if "pcm_refine" in t \
        else None
