"""Whole runs of the harness on the CPU at a small size: a sound run is
correct; the control (the reference at the next lower precision in the
program's place) and each fault planted under the timed path are not.
And a run loads neither JAX nor the JAX package."""
import subprocess
import sys

import numpy as np
import pytest

from bench_port import cells

from .helpers import cpu_run, small_cell

CONFIG_NAMES = ("stc007_pal_normal", "pcm16x0_si_normal")

CELLS = ("stc007_pal_normal.tapes8", "pcm16x0_si_normal.tapes8",
         "stc007_pal_normal.dropouts8")
CONTROL_BITS = {"stc007": 13, "pcm16x0": 15}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, tmp_path):
    out = cpu_run(small_cell(name), tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, tmp_path):
    cell = small_cell(name)
    bits = CONTROL_BITS[cell.config["format"]]
    out = cpu_run(cell, tmp_path, control_bits=bits)
    assert not out["correct"]
    assert out["checks"]["wrong_share"]["value"] > 0.25


def _half_the_batch(monkeypatch):
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver
    run = device_driver.StagedDeviceDecoder.run

    def half(self):
        self.jobs = self.jobs[:len(self.jobs) // 2]
        return run(self)
    monkeypatch.setattr(device_driver.StagedDeviceDecoder, "run", half)


def _answer_altered(monkeypatch):
    from sdvpcmdecoder_tpu_torch.pipeline import wav
    write = wav.WavWriter.write

    def altered(self, samples):
        return write(self, np.asarray(samples, np.int16) ^ 1)
    monkeypatch.setattr(wav.WavWriter, "write", altered)


def _state_unchanged(monkeypatch):
    """Every round hands back the first round's results."""
    from sdvpcmdecoder_tpu_torch.pipeline import device_driver, device_pcm
    for mod in (device_driver, device_pcm):
        run_round = mod.run_round
        first = {}

        def stale(*a, _run=run_round, _first=first, **k):
            res = _run(*a, **k)
            one = isinstance(res, tuple)
            parts = res[:2] if one else (res,)
            key = tuple(p.shape for p in parts)
            if key not in _first:
                _first[key] = tuple(p.clone() for p in parts)
            held = _first[key]
            return (*held, *res[2:]) if one else held[0]
        monkeypatch.setattr(mod, "run_round", stale)


FAULTS = {"half_the_batch": _half_the_batch,
          "answer_altered": _answer_altered,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault, tmp_path,
                                                     monkeypatch):
    FAULTS[fault](monkeypatch)
    # Two rounds a capture, so a stale round's shape recurs.
    frames = (16, 20) if fault == "state_unchanged" else (6, 10)
    out = cpu_run(small_cell(name, frames=frames), tmp_path)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_the_decoder_is_built_as_the_configuration_names_it(name):
    from sdvpcmdecoder_tpu_torch.pipeline import audio
    from bench_port import harness
    cfg = cells.load_json(cells.HERE / "configs" / f"{name}.json")
    cls, kw = harness.driver(cfg, "cpu")
    assert cls.__name__ == cfg["decoder"]["class"].rsplit(".", 1)[1]
    assert kw["mask_mode"] == audio.DROP_INTER_LIN_WORD
    assert kw["device"] == "cpu"
    with pytest.raises(TypeError, match="bogus"):
        cls([], **kw, bogus=1)
    cfg["decoder"]["graphs"] = False           # a key nothing would read
    with pytest.raises(ValueError):
        harness.driver(cfg, "cpu")


BLOCKED_RUN = r'''
import importlib.abc, sys, time, tempfile
BLOCK = {"jax", "jaxlib", "flax", "sdvpcmdecoder_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
from bench_port import harness
from bench_port.tests.helpers import small_cell
with tempfile.TemporaryDirectory() as tmp:
    out = harness.run_cell(small_cell(sys.argv[1]), 3, 0.2, False, "cpu",
                           time.time(), tmp)
top = {m.split(".")[0] for m in sys.modules}
assert not top & BLOCK, top & BLOCK
assert "sdvpcmdecoder_tpu_torch" in top
print("correct", out["correct"])
'''


@pytest.mark.parametrize("name", ["stc007_pal_normal.tapes8",
                                  "pcm16x0_si_normal.tapes8"])
def test_a_run_loads_neither_jax_nor_the_jax_package(name):
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, name],
                       cwd=cells.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("correct True")


def test_the_import_check_compares_whole_top_level_names():
    from bench_port import harness
    names = ["sdvpcmdecoder_tpu_torch.ops", "jaxtyping", "numpy"]
    assert not {m.split(".")[0] for m in names} & set(harness.FORBIDDEN)
    assert {m.split(".")[0] for m in ["sdvpcmdecoder_tpu.ops"]} \
        & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_a_short_run_on_the_card(card, tmp_path):
    """The command as the benchmark's runs give it, on a card."""
    r = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "stc007_pal_normal.tapes8", "--seed", str(2 ** 31 + 5),
         "--seconds", "2", "--trace", "0"], cwd=cells.ROOT,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
