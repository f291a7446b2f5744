"""Host milliseconds a frame in the program's `stage_t["pcm_round"]` span
(each PCM round's parameter packing and its launch, replayed as a CUDA
graph, inside `dispatch`), summed over the window's decoders. None where
the program has no such span."""


def read(rec):
    t = rec.stage_t
    return 1e3 * t["pcm_round"] / rec.frames if "pcm_round" in t else None
