"""Share of the window's staged chunks whose read, started ahead on a
pool thread, had ended when the chunk was staged: the program's counters
stage_t["count_stage_readahead_chunks"] over stage_t["count_stage_chunks"],
summed over the window's decoders (a counter never added reads 0). None
where the program read no chunk ahead (no `stage_readahead` span: a
program from before the read ahead) or has no `count_stage_chunks`."""


def read(rec):
    t = rec.stage_t
    n = t.get("count_stage_chunks")
    if not n or "stage_readahead" not in t:
        return None
    return t.get("count_stage_readahead_chunks", 0.0) / n
