"""Share of the window's decoded lines (PCM-16x0: sublines, three a line)
that the PCM frame driver passed to its per-line refinement: the
program's counter `stage_t["count_pcm_refined_lines"]` over the window's
frames times the configuration's lines a frame (a counter never added to
reads 0). None where the program has no `pcm_coord_search` span: one
that lacks the sweep's span lacks this counter too."""

SUBLINES = {"pcm16x0": 3}


def read(rec):
    t = rec.stage_t
    if "pcm_coord_search" not in t:
        return None
    cfg = rec.cell.config
    lines = 2 * cfg["signal"]["lines_per_field"] \
        * SUBLINES.get(cfg["format"], 1)
    return t.get("count_pcm_refined_lines", 0.0) / (rec.frames * lines)
