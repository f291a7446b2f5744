"""Share of the window's rounds that were a replay of a graph already
captured: (replays - captures) / (eager_rounds + replays), from each
decoder's RoundGraphs counters (a capture is counted as a replay too)."""


def read(rec):
    g = rec.graphs
    n = g["eager_rounds"] + g["replays"]
    return (g["replays"] - g["captures"]) / n if n else None
