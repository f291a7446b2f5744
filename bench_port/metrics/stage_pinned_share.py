"""Share of the window's staged chunks that went to the card from a
pinned host buffer: the program's counters
stage_t["count_stage_pinned_chunks"] over stage_t["count_stage_chunks"],
summed over the window's decoders (a counter never added to reads 0).
None where the program has no `count_stage_chunks`, as one that stages
from pageable memory has not."""


def read(rec):
    t = rec.stage_t
    n = t.get("count_stage_chunks")
    return t.get("count_stage_pinned_chunks", 0.0) / n if n else None
