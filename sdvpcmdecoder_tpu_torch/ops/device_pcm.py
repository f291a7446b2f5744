"""Packed device rounds for the PCM-1 / PCM-16x0 decode.

Port of sdvpcmdecoder_tpu/ops/device_pcm.py.  The chip-resident PCM
driver (pipeline/device_pcm.py) stages a capture's pixels on the device
once and decodes a round of frames per call: the trial-grid binarize
(ops/binarize.pcm1_frame_decode / pcm16x0_frame_decode, plain torch on
the pixels' device) and ONE int32 buffer that carries every host-bound
fact back — words, source CRCs, validity, control bits.  Unlike STC-007
(whose cross-frame interleave demands device seam speculation,
ops/device_stitch.py), these formats stitch per frame, so the words
themselves are the replay contract: the host feeds them to the native
steady-frame stitchers (pcm1_steady_frame / pcm16x0_steady_frame,
stitchcore.cpp) unchanged.

Reference scope: the per-frame V2D loop feeding PCM1DataStitcher /
PCM16X0DataStitcher (videotodigital.cpp:698 doBinarize routing,
pcm1datastitcher.cpp:1578 / pcm16x0datastitcher.cpp:5652
doFrameReassemble).
"""
from __future__ import annotations

import numpy as np
import torch

from . import binarize as bz


def round_param_layout(F):
    """Offsets into the packed per-round int32 parameter vector (one
    upload per round; mirrors device_stitch.round_param_layout)."""
    o, n = {}, 0
    for key, sz in (("coords", 2 * F), ("refs", F), ("blacks", F),
                    ("whites", F), ("usable", F)):
        o[key] = n
        n += sz
    return o, n


def pcm_round_packed(pixels, params, fmt, shift_limit, hyst_limit):
    """One round of PCM frames on resident pixels.

    pixels [F, L, W] uint8 (a device-resident slice), params int32 tensor
    on the same device (round_param_layout).  Returns ONE int32 buffer:

      pcm1:    [F*L*6 words | F*L meta]          meta = crc | valid<<16
      pcm16x0: [F*L*9 words | F*L*3 meta | F*L ctrl]

    Unusable frames zero out (the host builds dummy stores for them).
    """
    F, L, W = pixels.shape
    o, _n = round_param_layout(F)

    def cut(key, sz):
        return params[o[key]:o[key] + sz]

    coords = cut("coords", 2 * F).reshape(F, 2)
    refs = cut("refs", F)
    blacks = cut("blacks", F)
    whites = cut("whites", F)
    usable = cut("usable", F).to(torch.bool)

    def meta(c, v):
        return (c.to(torch.int32) & 0xFFFF) | (v.to(torch.int32) << 16)

    if fmt == "pcm1":
        w, c, v = bz.pcm1_frame_decode(
            pixels, coords, refs, blacks, whites,
            shift_limit=shift_limit, hyst_limit=hyst_limit)
        w = torch.where(usable[:, None, None], w.to(torch.int32), 0)
        m = torch.where(usable[:, None], meta(c, v), 0)
        return torch.cat([w.reshape(-1), m.reshape(-1)])
    w, c, v, ctrl = bz.pcm16x0_frame_decode(
        pixels, coords, refs, blacks, whites,
        shift_limit=shift_limit, hyst_limit=hyst_limit)
    w = torch.where(usable[:, None, None, None], w.to(torch.int32), 0)
    m = torch.where(usable[:, None, None], meta(c, v), 0)
    ctrl = torch.where(usable[:, None], ctrl.to(torch.int32), 0)
    return torch.cat([w.reshape(-1), m.reshape(-1), ctrl.reshape(-1)])


def unpack_round(buf, F, L, fmt):
    """Host split of pcm_round_packed's buffer (a numpy int32 array).

    pcm1    -> (words [F,L,6] i64, crc [F,L] i64, valid [F,L] bool, None)
    pcm16x0 -> (words [F,L,3,3] i64, crc [F,L,3] i64, valid [F,L,3]
                bool, ctrl [F,L] i64)
    """
    if fmt == "pcm1":
        n_w = F * L * 6
        words = buf[:n_w].reshape(F, L, 6).astype(np.int64)
        meta = buf[n_w:n_w + F * L].reshape(F, L)
        return (words, (meta & 0xFFFF).astype(np.int64),
                (meta & (1 << 16)) != 0, None)
    n_w = F * L * 9
    words = buf[:n_w].reshape(F, L, 3, 3).astype(np.int64)
    pos = n_w
    meta = buf[pos:pos + F * L * 3].reshape(F, L, 3)
    pos += F * L * 3
    ctrl = buf[pos:pos + F * L].reshape(F, L).astype(np.int64)
    return (words, (meta & 0xFFFF).astype(np.int64),
            (meta & (1 << 16)) != 0, ctrl)
