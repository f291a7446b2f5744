"""The port runs without JAX and without the JAX package: a GPU machine
has no JAX, so sdvpcmdecoder_tpu_torch and chip_smoke.py must import
neither, and a tree that holds only the two of them builds and runs."""
import fnmatch
import hashlib
import importlib
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sdvpcmdecoder_tpu_torch"

# Runs the slice at a small size with `jax` and the JAX package blocked:
# importing either raises ImportError.
SLICE = r"""
import sys
sys.modules["jax"] = None
sys.modules["sdvpcmdecoder_tpu"] = None
import tempfile
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from sdvpcmdecoder_tpu_torch.formats import stc007
from sdvpcmdecoder_tpu_torch.pipeline import audio, decoder, wav
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

F, LF, W = 2, 120, 1152
rng = np.random.default_rng(0)
n = 3 * F * LF
left, right = rng.integers(0, 1 << 14, (2, n))
pixels, coords, *_ = enc.encode_stream(left, right, width=W, ppb=8.0,
                                       n_lines=F * LF, noise_sigma=10.0,
                                       rng=rng)
lv = [torch.full((F,), v, dtype=torch.int32) for v in (110, 20, 200)]
res = decoder.decode_frames(torch.from_numpy(pixels.reshape(F, LF, W)),
                            torch.from_numpy(coords[::LF]), *lv)
nb = F * LF - stc007.MIN_DEINT_DATA
expect = stc007.expand_sample(torch.from_numpy(left[:3 * nb]))
assert bool(res.line_valid.all()) and torch.equal(res.samples[:, 0], expect)
out = audio.AudioProcessor().process(res.samples.numpy(),
                                     res.sample_valid.numpy())
with tempfile.TemporaryDirectory() as tmp:
    path = Path(tmp) / "slice.wav"
    wav.write_wav(path, out, sample_rate=44056)
    back, _ = wav.read_wav(path)
assert np.array_equal(back, res.samples.numpy())

# The stream chain's graphs (the CPU's stand-in): decode_frames and
# decode_stream replay from this thread's holder after a key's eager use
# and its capture, with the eager results.
from sdvpcmdecoder_tpu_torch.ops.round_graph import thread_graphs
sg = thread_graphs("cpu")   # the thread's holder: decode_frames' so far
frames3 = (torch.from_numpy(pixels.reshape(F, LF, W)),
           torch.from_numpy(coords[::LF]), *lv)
for _ in range(2):
    again = decoder.decode_frames(*frames3)
    assert all(torch.equal(a, b) for a, b in zip(again, res))
lines = [torch.from_numpy(pixels), torch.from_numpy(coords.astype(np.int32))]
lines += [torch.full((F * LF,), v, dtype=torch.int32) for v in (110, 20, 200)]
first = decoder.decode_stream(*lines, hyst_limit=1, shift_limit=1,
                              graphs=False)
for _ in range(3):
    again = decoder.decode_stream(*lines, hyst_limit=1, shift_limit=1)
    assert all(torch.equal(a, b) for a, b in zip(again, first))
assert (sg.eager_rounds, sg.captures, sg.replays) == (2, 2, 4)

# The streaming backend's graphs: V2DDriver's dispatch and level sweep.
from sdvpcmdecoder_tpu_torch.pipeline import v2d as tv2d
before = (sg.eager_rounds, sg.captures, sg.replays)
drvs = [tv2d.V2DDriver(device="cpu", hyst_limit=2, shift_limit=1,
                       graphs=g) for g in (True, False)]
px_np = pixels.reshape(F, LF, W)
sweep_in = (px_np[:, :24], coords[::LF], np.full(F, 20), np.full(F, 200))
for _ in range(3):
    a, b = (d.dispatch_frames(px_np, d.prepare_frames(px_np)) for d in drvs)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    a, b = (d._sweep_decode(*sweep_in) for d in drvs)
    assert all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4]))
    assert torch.equal(a.words, b.words)
assert drvs[0].graphs is sg and tuple(
    x - y for x, y in zip((sg.eager_rounds, sg.captures, sg.replays),
                          before)) == (2, 2, 4)

# The round (device_stitch + the round geometry) and K2's wrapper.
from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
px3 = torch.from_numpy(pixels.reshape(F, LF, W))
rows = dd._RoundRows(F, LF // 2, 0, 0, 0, LF // 2, True, device="cpu")
o, n_par = ds.round_param_layout(F)
params = np.zeros(n_par, np.int32)
params[o["coords"]:o["coords"] + 2 * F] = coords[::LF].ravel()
for key, v in (("refs", 110), ("blacks", 20), ("whites", 200), ("usable", 1)):
    params[o[key]:o[key] + F] = v
out, wflat, state = dd.run_round(
    px3, params, dd.RoundState.zeros(LF, "cpu"), rows, en_p=True, en_q=True,
    m2=False, hyst_limit=4, shift_limit=2, use_kernel=True, chained=False,
    tables=ds.RoundTables())
assert ds.unpack_round(out.numpy(), F, LF, rows.Bc)[1].all()
# The same round through a graph (the CPU's stand-in): eager on the key's
# first use, captured on its second, replayed after.
from sdvpcmdecoder_tpu_torch.ops.round_graph import RoundGraphs
graphs, tables = RoundGraphs("cpu"), ds.RoundTables()
for _ in range(3):
    g_out, g_wflat, _ = dd.run_round(
        px3, params, dd.RoundState.zeros(LF, "cpu"), rows, en_p=True,
        en_q=True, m2=False, hyst_limit=4, shift_limit=2, use_kernel=True,
        chained=False, tables=tables, graphs=graphs)
    assert torch.equal(g_out, out) and torch.equal(g_wflat, wflat)
assert (graphs.eager_rounds, graphs.captures, graphs.replays) == (1, 1, 2)
grp = fb.stc007_fused_decode(px3[0], tuple(coords[0]),
                             *(torch.full((LF,), v, dtype=torch.int32)
                               for v in (110, 20, 200)))
assert bool(grp.valid.all()) and torch.equal(grp.words, wflat[:LF])

# The chip-resident driver, captures in and WAV out, on the CPU: the
# native core, the stitcher, V2D and the round, all without JAX.
import chip_smoke
from sdvpcmdecoder_tpu_torch.ops import stitch_native as sn
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd2
with tempfile.TemporaryDirectory() as tmp:
    cap = chip_smoke.write_capture(f"{tmp}/c.y4m", 6, 294, seed=1)
    dec = dd2.DeviceBatchDecoder([(cap, f"{tmp}/o.wav")], hyst_limit=2,
                                 shift_limit=1, frames_per_round=3,
                                 device="cpu")
    stats = dec.run()[cap]
    back, rate = wav.read_wav(f"{tmp}/o.wav")
assert sn.available() and dec.jobs[0].stitcher.seam_backend == "tpu-spec"
assert dec.graphs.eager_rounds == 2   # round 0, the first chained round
assert len(back) > 0 and rate == 44100 and stats.lines_valid == 6 * 588

# The level sweep, the streaming backends and the CLI.
from sdvpcmdecoder_tpu_torch.ops import binarize as bz
from sdvpcmdecoder_tpu_torch.pipeline import batch_driver as bd
from sdvpcmdecoder_tpu_torch.pipeline import full_decoder, live_audio, render
from sdvpcmdecoder_tpu_torch.utils import dump
from sdvpcmdecoder_tpu_torch.__main__ import main as cli_main
sw = fb.stc007_ref_sweep_decode(
    px3[:, :24].contiguous(), torch.from_numpy(coords[::LF]),
    torch.full((F,), 20, dtype=torch.int32),
    torch.full((F,), 200, dtype=torch.int32),
    torch.arange(254, 1, -4, dtype=torch.int32), hyst_limit=2, shift_limit=1)
pick, good, _ = bz.pick_ref_sweep(*(sw[k].reshape(64, -1).numpy()
                                    for k in ("valid", "crc", "hyst",
                                              "shift")))
assert (pick >= 0).all() and good.all()
with tempfile.TemporaryDirectory() as tmp:
    cap = chip_smoke.write_capture(f"{tmp}/n.y4m", 4, 48, seed=2, noise=36.0)
    wavs = {}
    for backend in ("native", "tpu"):
        dec = bd.BatchDecoder([(cap, f"{tmp}/{backend}.wav")], hyst_limit=4,
                              shift_limit=2, frames_per_round=2,
                              lines_per_field=None, backend=backend,
                              ref_sweep_fallback=True,
                              normal_sweep_prescan=True, device="cpu")
        dec.run()
        assert dec.jobs[0].driver.sweep_calls > 0
        wavs[backend] = open(f"{tmp}/{backend}.wav", "rb").read()
    assert wavs["native"] == wavs["tpu"] and len(wavs["tpu"]) > 1000
    for backend, quality in (("auto", "normal"), ("tpu", "insane"),
                             ("device", "normal")):
        assert cli_main([cap, "-o", f"{tmp}/cli.wav", "--backend", backend,
                         "--quality", quality, "--batch", "2", "--device",
                         "cpu"]) == 0
        same = open(f"{tmp}/cli.wav", "rb").read() == wavs["tpu"]
        assert same or quality == "insane", (backend, quality)
    assert cli_main([cap, "--format", "arvid", "--device", "cpu"]) == 0

# PCM-1 / PCM-16x0: the probe, BatchDecoder, the chip-resident PCM driver
# and the CLI.
from sdvpcmdecoder_tpu_torch.pipeline import device_pcm, probe
with tempfile.TemporaryDirectory() as tmp:
    p1 = chip_smoke.write_pcm1_capture(f"{tmp}/p1.y4m", n_frames=2, seed=31)
    p16 = chip_smoke.write_pcm16x0_capture(f"{tmp}/p16.y4m", n_frames=2,
                                           seed=32)
    assert probe.probe_capture(p1)[0] == "pcm1"
    assert probe.probe_capture(p16)[0] == "pcm16x0"
    kw = dict(fmt="pcm16x0", hyst_limit=0, shift_limit=1,
              frames_per_round=2, device="cpu")
    bd.BatchDecoder([(p16, f"{tmp}/b16.wav")], **kw).run()
    device_pcm.DevicePCMBatchDecoder([(p16, f"{tmp}/d16.wav")], **kw).run()
    b16 = open(f"{tmp}/b16.wav", "rb").read()
    assert b16 == open(f"{tmp}/d16.wav", "rb").read() and len(b16) > 1000
    # The PCM grid on the device, a graph replayed from its second batch.
    replays = sg.replays
    dec = bd.BatchDecoder([(p16, f"{tmp}/g16.wav")], backend="tpu",
                          **dict(kw, frames_per_round=1))
    dec.run()
    assert open(f"{tmp}/g16.wav", "rb").read() == b16
    assert dec.stream_graphs is sg and sg.replays == replays + 1
    for fmt, cap, backend in (("pcm1", p1, "tpu"), ("auto", p1, "native"),
                              ("pcm16x0", p16, "device")):
        assert cli_main([cap, "-o", f"{tmp}/c.wav", "--format", fmt,
                         "--backend", backend, "--device", "cpu"]) == 0

# The stitcher's device seam route (seam_backend="tpu"): its block evals
# and padding searches replay from this thread's holder; the golden PAL
# capture's WAV hashes as the JAX package's under both routes.
import hashlib
with tempfile.TemporaryDirectory() as tmp:
    cap = chip_smoke.write_capture(f"{tmp}/g.y4m", 12, 294, seed=1)
    for graphs in (True, False):
        before = (sg.eager_rounds, sg.captures, sg.replays)
        dec = bd.BatchDecoder([(cap, f"{tmp}/s.wav")], hyst_limit=2,
                              shift_limit=1, frames_per_round=5,
                              seam_backend="tpu", graphs=graphs,
                              device="cpu")
        dec.run()
        assert dec.jobs[0].stitcher.graphs is graphs
        digest = hashlib.sha256(open(f"{tmp}/s.wav", "rb").read())
        assert digest.hexdigest() == chip_smoke.GOLDEN_SHA256["pal"]
        moved = (sg.eager_rounds, sg.captures, sg.replays) != before
        assert moved == graphs and (not graphs or sg.replays > before[2])

# Containers and their codecs, ArVid, V4L2 capture, multi-GPU and the
# device histogram.
from sdvpcmdecoder_tpu_torch.formats import arvid
from sdvpcmdecoder_tpu_torch.ops import agc
from sdvpcmdecoder_tpu_torch.parallel import mesh as pm
from sdvpcmdecoder_tpu_torch.parallel.multichip import ShardedBatchDecoder
from sdvpcmdecoder_tpu_torch.pipeline import (arvid_pipe, avi, capture,
                                              ffv1, huffyuv, ingest,
                                              lagarith, mkv, utvideo)
small = np.random.default_rng(3).integers(0, 256, (2, 16, 24), np.uint8)
with tempfile.TemporaryDirectory() as tmp:
    for codec in ("Y800", "HFYU", "LAGS", "ULY0", "FFV1"):
        for ext, writer in ((".avi", avi.write_avi), (".mkv", mkv.write_mkv)):
            path = f"{tmp}/s{codec}{ext}"
            writer(path, small, codec=codec, drops=[1])
            with ingest.open_capture(path) as rd:
                got = rd.read_frames(0, 3)
            assert np.array_equal(got[[0, 2]], small) and not got[1].any()
    cap = chip_smoke.write_capture(f"{tmp}/a.y4m", 2, 294, seed=1)
    with ingest.open_capture(cap) as rd:
        avi.write_avi(f"{tmp}/a.avi", rd.read_frames(0, 2), codec="ULY0")
    assert cli_main([f"{tmp}/a.avi", "-o", f"{tmp}/a.wav", "--device",
                     "cpu", "--quality", "fast"]) == 0
    acap, acd = chip_smoke.write_arvid_capture(f"{tmp}/ar.y4m", n_frames=1)
    assert cli_main([acap, "-o", f"{tmp}/ar.txt", "--format", "arvid",
                     "--force-coords", f"{acd[0]}:{acd[1]}", "--device",
                     "cpu"]) == 0
    jobs = [(cap, f"{tmp}/m0.wav"), (f"{tmp}/a.avi", f"{tmp}/m1.wav")]
    sh = ShardedBatchDecoder(jobs, devices=["cpu", "cpu"], hyst_limit=1,
                             shift_limit=1, frames_per_round=2)
    sh.run()
    assert open(f"{tmp}/m0.wav", "rb").read() == \
        open(f"{tmp}/m1.wav", "rb").read() and sh.stats[0] == 4
grid = pm.decode_mesh(2, seq=2, devices=["cpu"])
assert grid.shape == (1, 2)
sel = capture.CaptureSelector(lambda: [])
sel.set_pal()
assert (sel.config.width, sel.config.height) == (720, 576)
hist = agc.line_histograms_device(px3[0, :4], torch.ones(4, W, dtype=bool))
assert int(hist.sum()) == 4 * W and hist.dtype == torch.int32
assert arvid.BITS_PCM_DATA == 144 and callable(arvid_pipe.decode_frames)
assert all(m.__name__.startswith("sdvpcmdecoder_tpu_torch.")
           for m in (ffv1, huffyuv, lagarith, utvideo))
assert not any(m == "jax" or m.startswith(("jax.", "sdvpcmdecoder_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
# Everything ran from the tree in the working directory: its package, its
# native sources and the libraries it built.
import sdvpcmdecoder_tpu_torch
here = Path.cwd().resolve()
assert Path(sdvpcmdecoder_tpu_torch.__file__).resolve().is_relative_to(here)
assert sn.NATIVE_SRC.is_relative_to(here)
for lib in (sn._load()._name, ingest._native_lib()._name):
    assert Path(lib).parent == here / "build" / "native", lib
print("SLICE_OK")
"""


@pytest.mark.parametrize("tree", ["in_repo", "port_only"])
def test_slice_runs_with_jax_blocked(tree, tmp_path):
    env = dict(os.environ)
    if tree == "port_only":
        cwd = chip_smoke.port_only_tree(tmp_path)
        env.pop("PYTHONPATH", None)
    else:
        cwd = ROOT
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SLICE_OK" in proc.stdout
    if tree == "port_only":
        assert not (cwd / "sdvpcmdecoder_tpu").exists()
        built = sorted(p.name for p in (cwd / "build" / "native").iterdir())
        for stem in ("libstitchcore-", "libloader-"):
            assert any(n.startswith(stem) and n.endswith(".so")
                       for n in built), built


def test_native_sources_are_the_ports_own(monkeypatch, tmp_path):
    """Every source the port compiles lies in the port and ships as its
    package data; the port has its own console script."""
    from sdvpcmdecoder_tpu_torch.ops import _kernels
    from sdvpcmdecoder_tpu_torch.ops import stitch_native as sn
    from sdvpcmdecoder_tpu_torch.pipeline import ingest

    assert sn.NATIVE_SRC.is_relative_to(PORT)
    # Record what the compilers are handed, from empty build dirs, and
    # fail every compile: nothing is built.
    compiled = []

    def fake_run(cmd, **kw):
        compiled.extend(Path(a) for a in cmd if a.endswith((".cpp", ".cu")))
        return subprocess.CompletedProcess(cmd, 1, "", "not compiled")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(sn, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(sn, "_LIB", None)
    monkeypatch.setattr(ingest, "_NATIVE", None)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.delenv("SDV_NO_NATIVE", raising=False)
    builds = [sn._load, ingest._native_lib] + [
        lambda name=name: _kernels.build.__wrapped__(name)
        for name in _kernels.SIGNATURES]
    for call in builds:
        n = len(compiled)
        with pytest.raises(RuntimeError):
            call()
        assert len(compiled) > n, call
    assert {p.name for p in compiled} >= {"stitchcore.cpp", "loader.cpp"}

    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = project["tool"]["setuptools"]["package-data"][PORT.name]
    for src in set(compiled):
        assert src.is_file() and src.is_relative_to(PORT), src
        rel = src.relative_to(PORT).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)

    entry = project["project"]["scripts"]["sdvpcmdecoder-tpu-torch"]
    module, _, attr = entry.partition(":")
    cli = importlib.import_module("sdvpcmdecoder_tpu_torch.__main__")
    assert getattr(importlib.import_module(module), attr) is cli.main

    # loader.cpp is still byte for byte the JAX package's; stitchcore.cpp
    # has the port's own PCM-16x0 sweep over all three sublines.
    jax_native = ROOT / "sdvpcmdecoder_tpu" / "native"
    digest = {name: [hashlib.sha256((d / name).read_bytes()).digest()
                     for d in (sn.NATIVE_SRC, jax_native)]
              for name in ("stitchcore.cpp", "loader.cpp")}
    assert digest["loader.cpp"][0] == digest["loader.cpp"][1]
    assert digest["stitchcore.cpp"][0] != digest["stitchcore.cpp"][1]
    assert "sweep_trial_all_parts" in (sn.NATIVE_SRC
                                       / "stitchcore.cpp").read_text()


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+sdvpcmdecoder_tpu\b(?!_)"
        r"|from\s+sdvpcmdecoder_tpu\b(?!_))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(p.relative_to(PORT)) for p in files[:-1]}
    assert {"ops/stitch_native.py", "ops/agc.py", "ops/markers.py",
            "pipeline/stitcher_stc007.py", "pipeline/v2d.py",
            "pipeline/batch_driver.py", "pipeline/device_driver.py",
            "pipeline/ingest.py", "utils/stats.py", "utils/resume.py",
            "utils/host.py", "__main__.py", "pipeline/full_decoder.py",
            "pipeline/live_audio.py", "pipeline/render.py",
            "utils/dump.py", "formats/pcm1.py", "formats/pcm16x0.py",
            "ops/pcm1_deint.py", "ops/pcm16x0_deint.py",
            "ops/line_decode_np.py", "ops/device_pcm.py",
            "pipeline/stitcher_pcm1.py", "pipeline/stitcher_pcm16x0.py",
            "pipeline/v2d_other.py", "pipeline/probe.py",
            "pipeline/device_pcm.py", "pipeline/avi.py", "pipeline/mkv.py",
            "pipeline/huffyuv.py", "pipeline/utvideo.py",
            "pipeline/lagarith.py", "pipeline/ffv1.py", "formats/arvid.py",
            "pipeline/arvid_pipe.py", "pipeline/capture.py",
            "parallel/mesh.py", "parallel/multichip.py",
            "ops/round_graph.py"} <= names
    for path in files:
        text = path.read_text()
        assert "import jax" not in text, path
        assert not pattern.search(text), path


def test_chip_smoke_refuses_without_cuda():
    """No CPU fallback: without a CUDA device chip_smoke.py exits non-zero
    and prints no result line."""
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; torch.cuda.is_available = "
         "lambda: False; import runpy; runpy.run_path('chip_smoke.py', "
         "run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
