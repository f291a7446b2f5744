"""Port checks: ops/device_stitch.py and the round geometry of
pipeline/device_driver.py in sdvpcmdecoder_tpu_torch against the JAX
package, exactly.

Inputs are made from numpy seeds and handed to both sides. Every output is
an integer or a bool, so every comparison is exact and checks the dtype
too, with one documented exception: the JAX package's packed block words
are uint32, the port's int64 (torch has almost no uint32 arithmetic); they
are compared by value. The JAX round runs with use_pallas=False, its XLA
binarize, and the port's with use_kernel=True, which on a CPU tensor runs
the kernel's plain version.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdvpcmdecoder_tpu.formats import stc007 as jst
from sdvpcmdecoder_tpu.ops import deinterleave as jdi
from sdvpcmdecoder_tpu.ops import device_stitch as jds
from sdvpcmdecoder_tpu.pipeline import device_driver as jdd
from sdvpcmdecoder_tpu_torch.ops import deinterleave as di
from sdvpcmdecoder_tpu_torch.ops import device_stitch as ds
from sdvpcmdecoder_tpu_torch.ops import fused_binarize as fb
from sdvpcmdecoder_tpu_torch.pipeline import device_driver as dd
from sdvpcmdecoder_tpu_torch.synth import encoder as enc

torch.set_num_threads(1)

W = 1152
MDD = 112
MODES = (di.RES_MODE_14BIT, di.RES_MODE_14BIT_AUTO, di.RES_MODE_16BIT_AUTO,
         di.RES_MODE_16BIT)


def assert_same(got, expect, what=""):
    """torch tensor vs JAX/numpy array: same dtype, shape and values."""
    expect = np.asarray(expect)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == expect.dtype, f"{what}: {got.dtype} != {expect.dtype}"
    np.testing.assert_array_equal(got, expect, err_msg=what)


def assert_blocks(got, expect):
    for name in got._fields:
        assert_same(getattr(got, name), getattr(expect, name), name)


def line_buffer(n_lines, seed, bad=0.15):
    """Encoded line words [L, 8] int32 with some lines' words corrupted and
    their CRC flags cleared, plus a few silently corrupted words."""
    rng = np.random.default_rng(seed)
    left, right = rng.integers(0, 1 << 14, (2, 3 * n_lines))
    words, _ = enc.blocks_to_lines(enc.samples_to_blocks(left, right),
                                   n_lines)
    words = words.astype(np.int32)
    ok = np.repeat(rng.random((n_lines, 1)) > bad, 8, axis=1)
    words[~ok] ^= rng.integers(1, 1 << 14, words.shape,
                               dtype=np.int32)[~ok]
    silent = rng.random(words.shape) < 0.01
    words[silent] ^= 1
    return words, ok


def t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


# ---- block-level primitives -------------------------------------------------

def test_assemble_rows_16_matches_jax():
    """Row maps with rows past both ends of the buffer (clamped as XLA's
    gather clamps them)."""
    words, ok = line_buffer(300, seed=1)
    rng = np.random.default_rng(2)
    rows = rng.integers(-40, 340, (400, 8)).astype(np.int32)
    got = ds.assemble_rows_16(t(words), t(ok), t(rows))
    expect = jds.assemble_rows_16(jnp.asarray(words), jnp.asarray(ok),
                                  jnp.asarray(rows))
    for name, g, e in zip(("w16", "c16", "w14", "c14"), got, expect):
        assert_same(g, e, name)


@pytest.mark.parametrize("mode", [*MODES, "per-block"])
def test_select_by_mode_and_flags_match_jax(mode):
    words, ok = line_buffer(700, seed=3, bad=0.25)
    rng = np.random.default_rng(4)
    rows = (np.arange(500)[:, None] + 16 * np.arange(8)[None, :]).astype(
        np.int32)
    modes = (rng.integers(0, 4, 500).astype(np.int32) if mode == "per-block"
             else mode)
    cwd = rng.random((500, 8)) < 0.1
    w16, c16, w14, c14 = jds.assemble_rows_16(
        jnp.asarray(words), jnp.asarray(ok), jnp.asarray(rows))
    j14 = jdi.correct_blocks(w14, c14, jdi.RES_14BIT)
    j16 = jdi.correct_blocks(w16, c16, jdi.RES_16BIT)
    p14 = di.correct_blocks(t(np.asarray(w14)), t(np.asarray(c14)),
                            di.RES_14BIT)
    p16 = di.correct_blocks(t(np.asarray(w16)), t(np.asarray(c16)),
                            di.RES_16BIT)
    jsel = jds.select_by_mode(j14, j16, jnp.asarray(modes))
    psel = ds.select_by_mode(p14, p16, t(np.asarray(modes)) if
                             mode == "per-block" else modes)
    assert_blocks(psel, jsel)
    assert len(set(psel.resolution.tolist())) == (1 if mode in (0, 3)
                                                  else 2)
    for m2 in (False, True):
        got = ds.blocks_flags_samples(psel, t(cwd), m2)
        expect = jds.blocks_flags_samples(jsel, jnp.asarray(cwd), m2)
        assert_same(got[0], expect[0], f"flags m2={m2}")
        assert_same(got[1], expect[1], f"samples m2={m2}")


@pytest.mark.parametrize("en_q", [True, False])
def test_burst_stats_batch_matches_jax(en_q):
    """Random flag runs over 64 seams, nb from 0 to B_MAX, per-seam
    unchecked limits."""
    rng = np.random.default_rng(5 + en_q)
    P, B = 64, ds.B_MAX
    kinds = np.array([
        ds.FLAG_BLOCK_VALID | ds.FLAG_CAN_FORCE,
        ds.FLAG_BLOCK_VALID | ds.FLAG_CAN_FORCE | ds.FLAG_SILENT,
        ds.FLAG_BROKEN, 0, ds.FLAG_BLOCK_VALID | ds.FLAG_FIX_P
        | ds.FLAG_CAN_FORCE, ds.FLAG_BLOCK_VALID | ds.FLAG_FIX_Q],
        dtype=np.uint8)
    # Runs: each seam repeats a kind for a random stretch.
    flags = np.zeros((P, B), np.uint8)
    for p in range(P):
        pos = 0
        while pos < B:
            n = int(rng.integers(1, 20))
            flags[p, pos:pos + n] = rng.choice(kinds, p=[.5, .2, .05, .1,
                                                          .1, .05])
            pos += n
    nb = rng.integers(0, B + 1, P).astype(np.int32)
    nb[:3] = (0, B, 1)
    unch = rng.integers(1, 12, P).astype(np.int32)
    got = ds.burst_stats_batch(t(flags), t(nb), t(unch), en_q,
                               ds.MAX_BURST_SILENCE, ds.MAX_BURST_BROKEN)
    expect = jds.burst_stats_batch(jnp.asarray(flags), jnp.asarray(nb),
                                   jnp.asarray(unch), en_q,
                                   jds.MAX_BURST_SILENCE,
                                   jds.MAX_BURST_BROKEN)
    assert_same(got, expect)
    assert got[:, 0].max() > 0 and got[:, 1].max() >= ds.MAX_BURST_SILENCE


@pytest.mark.parametrize("m2", [False, True])
def test_dup_device_matches_jax(m2):
    """Injected near-copies (within and past the bit-difference threshold),
    near-silent lines, copies across the field boundary and invalid lines
    between a line and its copy."""
    F, L = 3, 101                      # odd L: the first field has 51 rows
    rng = np.random.default_rng(7 + m2)
    words = rng.integers(0, 1 << 14, (F, L, 8)).astype(np.int32)
    crc = rng.integers(0, 1 << 16, (F, L)).astype(np.int32)
    valid = rng.random((F, L)) > 0.1
    for f in range(F):
        for k in rng.choice(np.arange(1, L), 30, replace=False):
            src = k - 1 if rng.random() < 0.7 else max(k - 3, 0)
            words[f, k] = words[f, src]
            crc[f, k] = crc[f, src]
            for _ in range(int(rng.integers(0, 40))):   # flip some bits
                words[f, k, rng.integers(0, 8)] ^= 1 << int(
                    rng.integers(0, 14))
        words[f, 51] = words[f, 50]                     # field boundary
        crc[f, 51] = crc[f, 50]
        valid[f, 50:52] = True
        quiet = rng.choice(L, 10, replace=False)        # near-silent lines
        words[f, quiet, :3] = rng.integers(0, 4, (10, 3))
    got = ds._dup_device(t(words), t(crc), t(valid), m2)
    expect = jds._dup_device(jnp.asarray(words), jnp.asarray(crc),
                             jnp.asarray(valid), m2)
    assert_same(got, expect)
    assert 0 < got.sum() < valid.sum()
    assert not got[:, 51].any()


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(9)
    x = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64)
    x[:4] = (0, -1, 1 << 31, (1 << 32) - 1)
    expect = np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x])
    np.testing.assert_array_equal(ds.popcount32(t(x)).numpy(), expect)


@pytest.mark.parametrize("en_p,en_q,m2", [(True, True, False),
                                          (True, False, True),
                                          (False, True, False)])
def test_dual_eval_matches_jax(en_p, en_q, m2):
    words, ok = line_buffer(600, seed=10, bad=0.2)
    rng = np.random.default_rng(11)
    rows = (rng.integers(0, 600 - MDD, 300)[:, None]
            + 16 * np.arange(8)[None, :]).astype(np.int32)
    pk, sm = ds._dual_eval(t(words), t(ok), t(rows), en_p, en_q, m2)
    jpk, jsm = jds._dual_eval(jnp.asarray(words), jnp.asarray(ok),
                              jnp.asarray(rows), en_p, en_q, m2)
    assert pk.dtype == torch.int64 and np.asarray(jpk).dtype == np.uint32
    assert_same(pk, np.asarray(jpk).astype(np.int64), "packed")
    assert_same(sm, jsm, "samples")
    assert int(pk.max()) < 1 << (ds.PACK_BAD_BIT + 1)


@pytest.mark.parametrize("explicit_rows", [False, True])
def test_eval_rows_arrays_matches_jax(explicit_rows):
    """All four resolution modes; contiguous shifts, and explicit rows
    reaching past the line buffer (into the JAX package's zero-padded
    128-line bucket and beyond it)."""
    L = 300
    words, ok = line_buffer(L, seed=12, bad=0.2)
    if explicit_rows:
        rng = np.random.default_rng(13)
        rows = rng.integers(0, 420, (150, 8)).astype(np.int64)
        cfg = dict(en_p=True, en_q=False, force_ecc=False, m2=True)
    else:
        rows = None
        cfg = dict(en_p=True, en_q=True, force_ecc=True, m2=False)
    for res_mode in MODES:
        args = (words, ok, rows, 5, 150, res_mode, *cfg.values())
        got = ds.eval_rows_arrays(*args, device="cpu")
        expect = jds.eval_rows_arrays(*args)
        for k, (g, e) in enumerate(zip(got, expect)):
            assert_same(g, e, f"res_mode={res_mode} output {k}")


SEAMS = [  # (n1, n2, en_p, en_q, m2, per-pad unch_lim, number of modes)
    (0, 150, True, True, False, False, 32),
    (50, 80, True, True, False, True, 20),
    (294, 294, True, True, False, False, 32),
    (130, 0, True, True, False, False, 32),
    (119, 121, True, False, True, True, 32),
]


@pytest.mark.parametrize("n1,n2,en_p,en_q,m2,per_pad,n_modes", SEAMS)
def test_seam_sweep_matches_jax(n1, n2, en_p, en_q, m2, per_pad, n_modes):
    """Field lengths 0, < KEEP and > KEEP, skipped pads (mode -1), fewer
    modes than P_MAX and per-pad unchecked limits."""
    rng = np.random.default_rng(n1 * 1000 + n2)
    w1, c1 = line_buffer(max(n1, 1), seed=n1 + 1, bad=0.3)
    w2, c2 = line_buffer(max(n2, 1), seed=n2 + 2, bad=0.3)
    w1, c1, w2, c2 = w1[:n1], c1[:n1], w2[:n2], c2[:n2]
    modes = rng.integers(-1, 4, n_modes).astype(np.int32)
    unch = (rng.integers(1, 10, n_modes).astype(np.int32) if per_pad
            else 4)
    silent = np.asarray(jst.silent_words(m2=m2), np.int32)
    args = (w1, c1, w2, c2, silent, modes, en_p, en_q, m2, unch)
    stats, has = ds.seam_sweep(*args, device="cpu")
    jstats, jhas = jds.seam_sweep(*args)
    assert_same(stats, jstats, "stats")
    assert_same(has, jhas, "has")
    if n1 + n2 > MDD:
        assert has.any()


# ---- round geometry ----------------------------------------------------------

@pytest.mark.parametrize("F", [1, 2, 16])
@pytest.mark.parametrize("lpf", [50, 100, 150, 294])
def test_round_rows_match_jax(F, lpf):
    """Every field of _RoundRows at TFF and BFF, zero and non-zero
    paddings, targets at and below lpf, and pair-0 carries of 0, 50 and
    112 rows: lpf <= 112 gives the [1, 8] g2 placeholder, lpf = 50 seam
    queues shorter than 112 (nb = 0) and no chain."""
    for padI, padO in ((0, 0), (3, 5)):
        for tff in (True, False):
            for n0 in (0, 50, MDD):
                for target in (lpf, lpf - 3):
                    key = (F, lpf, n0, padI, padO, target, tff)
                    j = jdd._RoundRows(*key)
                    p = dd._RoundRows(*key, device="cpu")
                    for name in ("g1", "g2", "nb_seam", "carry_next_rows"):
                        assert_same(getattr(p, name), getattr(j, name),
                                    f"{key} {name}")
                    for name in ("geom", "lpf", "B_conv", "can_chain",
                                 "meta1", "meta2", "meta_conv", "B1", "Bc",
                                 "B2"):
                        assert getattr(p, name) == getattr(j, name), \
                            (key, name)
    if lpf <= MDD:
        assert tuple(p.g2.shape) == (1, 8)
    if lpf == 50:
        assert not p.can_chain and int(p.nb_seam.max()) == 0


# ---- the steady round --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def capture(n_frames, lpf, seed):
    """Field-sequential encoder capture [F, 2*lpf, W] u8 at sigma=30, with
    Control-Block lines, duplicated lines and knocked-out (zeroed) lines;
    per-frame coords [F, 2]."""
    Ls = 2 * lpf
    n = n_frames * Ls
    rng = np.random.default_rng(seed)
    left, right = rng.integers(0, 1 << 14, (2, 3 * n))
    words, crcs = enc.blocks_to_lines(enc.samples_to_blocks(left, right), n)
    for k in rng.choice(n, 4, replace=False):
        words[k], crcs[k] = enc.control_block_line(index=int(k) % 64)
    pixels, coords = enc.render_lines(words, crcs, width=W, ppb=8.0,
                                      noise_sigma=30.0, rng=rng)
    for k in rng.choice(n - 1, n // 100, replace=False):
        pixels[k + 1] = pixels[k]
    pixels[rng.choice(n, n // 30, replace=False)] = 0
    return pixels.reshape(n_frames, Ls, W), coords[::Ls].astype(np.int32)


def round_params(coords, pred_mode, usable, carry, seed):
    F = len(coords)
    rng = np.random.default_rng(seed)
    o, n = ds.round_param_layout(F)
    params = np.zeros(n, np.int32)

    def put(key, a):
        a = np.asarray(a).ravel()
        params[o[key]:o[key] + a.size] = a

    put("coords", coords)
    put("refs", rng.integers(104, 117, F))
    put("blacks", np.full(F, 20))
    put("whites", np.full(F, 200))
    put("usable", usable)
    put("carry_w", carry[0])
    put("carry_ok", carry[1])
    put("pred_mode", pred_mode)
    put("unch_lim", 3)
    return params


ROUNDS = {
    "pred14": dict(pred_mode=di.RES_MODE_14BIT),
    "pred14auto": dict(pred_mode=di.RES_MODE_14BIT_AUTO),
    "pred16auto": dict(pred_mode=di.RES_MODE_16BIT_AUTO),
    "pred16": dict(pred_mode=di.RES_MODE_16BIT),
    "unusable_frame": dict(usable=(1, 0)),
    "m2": dict(m2=True),
    "en_q_off": dict(en_q=False),
    "carry50_pads_bff": dict(n0=50, padI=3, padO=2, tff=False),
    "chained": dict(rounds=2),
    "lpf50": dict(lpf=50),
    "F16_chained": dict(F=16, rounds=2),
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_steady_round_packed_matches_jax(case):
    """All six outputs of steady_round_packed byte-equal to the JAX
    package's, round after round: a chained round takes the previous
    round's tails and carry_next_*, handed to the port through
    RoundState.from_numpy."""
    c = dict(F=2, lpf=294, rounds=1, pred_mode=di.RES_MODE_14BIT_AUTO,
             usable=None, m2=False, en_q=True, n0=0, padI=0, padO=0,
             tff=True)
    c.update(ROUNDS[case])
    F, lpf, Ls = c["F"], c["lpf"], 2 * c["lpf"]
    px_all, cd_all = capture(F * c["rounds"], lpf, seed=F + lpf)
    carry = (np.zeros((MDD, 8), np.int32), np.zeros((MDD, 8), bool))
    if c["n0"]:
        w, ok = line_buffer(c["n0"], seed=c["n0"])
        carry[0][:c["n0"]], carry[1][:c["n0"]] = w, ok
    usable = np.ones(F, np.int32) if c["usable"] is None else c["usable"]
    cfg = dict(en_p=True, en_q=c["en_q"], m2=c["m2"], hyst_limit=4,
               shift_limit=2)
    tables = ds.RoundTables()
    silent = jnp.asarray(jst.silent_words(m2=c["m2"]))
    jstate = [np.zeros((Ls, 8), np.int32), np.zeros((Ls, 8), bool),
              np.zeros((MDD, 8), np.int32), np.zeros((MDD, 8), bool)]
    for r in range(c["rounds"]):
        chained = r > 0
        n0 = MDD if chained else c["n0"]
        key = (F, lpf, n0, c["padI"], c["padO"], lpf, c["tff"])
        jrows = jdd._RoundRows(*key)
        prows = dd._RoundRows(*key, device="cpu")
        if chained:
            assert prows.can_chain
        px = px_all[r * F:(r + 1) * F]
        params = round_params(cd_all[r * F:(r + 1) * F], c["pred_mode"],
                              usable, carry, seed=r)
        # The port's state comes from the JAX round's (numpy) state; its
        # own hand-over is compared with JAX's below.
        pstate = dd.RoundState.from_numpy(*jstate, device="cpu")
        expect = jds.steady_round_packed(
            jnp.asarray(px), jnp.asarray(params),
            *(jnp.asarray(a) for a in jstate),
            jrows.carry_next_rows, jrows.g1, jrows.g2, jrows.nb_seam,
            silent, B_conv=jrows.B_conv, use_pallas=False, chained=chained,
            **cfg)
        before = fb.stc007_fused_decode_frames.launches
        out, wflat, pstate = dd.run_round(
            t(px), params, pstate, prows, use_kernel=True, chained=chained,
            tables=tables, **cfg)
        assert fb.stc007_fused_decode_frames.launches == before
        got = (out, wflat, *pstate)
        for name, g, e in zip(("out", "wflat_rw", "words_tail", "ok8_tail",
                               "carry_next_w", "carry_next_ok"), got,
                              expect):
            assert_same(g, e, f"round {r}: {name}")
        jstate = [np.asarray(a) for a in expect[2:]]
        # The host split of the buffer: the i16 sample pairs round-trip
        # through their int32 words, and every selected pack is < 2**24.
        u = ds.unpack_round(out.numpy(), F, Ls, prows.Bc)
        ju = jds.unpack_round(np.asarray(expect[0]), F, Ls, jrows.Bc)
        for g, e in zip(u, ju):
            assert_same(g, e)
        assert (u[5] < 1 << 24).all()
        assert u[1].sum() < F * Ls and u[2].any()
        if c["usable"] is not None:
            assert not u[1][1].any()


def test_host_selects_match_jax():
    """The numpy host helpers carried over unchanged."""
    rng = np.random.default_rng(15)
    packed = rng.integers(0, 1 << 24, (200, 2)).astype(np.uint32)
    samples = rng.integers(-(1 << 15), 1 << 15, (200, 2, 6)).astype(np.int16)
    for mode in (*MODES, rng.integers(0, 4, 200)):
        for g, e in zip(ds.select_dual_host(packed, mode, samples),
                        jds.select_dual_host(packed, mode, samples)):
            assert_same(g, e)
    for g, e in zip(ds.unpack_eval_host(packed[:, 0]),
                    jds.unpack_eval_host(packed[:, 0])):
        assert_same(g, e)
