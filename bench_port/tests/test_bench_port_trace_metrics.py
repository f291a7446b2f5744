"""The readers of the program's own staging, construction and wait spans:
their arithmetic on a hand-made record, nothing read from a program that
lacks the spans, and what a CPU run of the cell reports."""
import pytest

from bench_port import cells, harness

from .helpers import small_cell

NEW = ("stage_read_ms_per_frame", "stage_split_ms_per_frame",
       "stage_upload_ms_per_frame", "construct_ms_per_frame",
       "host_wait_ms_per_frame")


def record(**stage_t):
    return harness.Record(frames=6400, stage_t=dict(stage_t))


def test_readers_on_a_hand_made_record():
    rec = record(stage_hbm=5.5, stage_read=3.2, stage_split=1.6,
                 stage_upload=0.64, construct=1.5, open=0.4, setup=0.24,
                 wait=0.32, dispatch=1.2)
    got = {m: cells.metric_reader(m)(rec) for m in NEW}
    assert got == pytest.approx(dict(
        stage_read_ms_per_frame=0.5, stage_split_ms_per_frame=0.25,
        stage_upload_ms_per_frame=0.1, construct_ms_per_frame=0.1,
        host_wait_ms_per_frame=0.05))
    # The staging parts stay within staging_ms_per_frame.
    assert sum(got[m] for m in NEW[:3]) <= \
        cells.metric_reader("staging_ms_per_frame")(rec)


def test_nothing_read_where_the_program_has_no_such_span():
    """A program from before these spans (its stage_t as the accepted
    benchmark's traced runs read it): every new reader gives None."""
    rec = record(stage_hbm=5.5, dispatch=1.2, prescan=0.1, materialize=0.3,
                 finalize=0.03, assemble=0.2, stitch=0.96, audio=0.4,
                 wav=0.13)
    assert [cells.metric_reader(m)(rec) for m in NEW] == [None] * len(NEW)


def test_the_cell_lists_the_new_metrics_for_its_traced_runs():
    cell = cells.Cell(cells.benchmark(), "stc007_pal_normal.tapes8")
    traced = [m["name"] for m in cell.metrics(True)]
    assert traced[-len(NEW):] == list(NEW)
    assert {m["name"] for m in cell.metrics(False)} == {"frames_per_s",
                                                         "setup_s"}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_cpu_run_reports_them_in_its_traced_line(trace, tmp_path):
    import time
    import torch
    torch.set_num_threads(2)
    cell = small_cell("stc007_pal_normal.tapes8")
    out = harness.run_cell(cell, 11, 0.5, trace, "cpu", time.time(),
                           tmp_path)
    assert out["correct"], out["checks"]
    if not trace:
        assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
        return
    # No card: the device trace's metrics are left out, the program's
    # spans are read.
    assert set(NEW) <= set(out["metrics"])
    for m in NEW:
        assert out["metrics"][m]["unit"] == "ms/frame"
        assert out["metrics"][m]["value"] > 0
