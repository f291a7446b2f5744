"""Full STC-007 decode pipeline: frames of pixels -> finished WAV.

Chains the device binarizer (ops.binarize frame-grouped trial grid), the
host stitcher (pipeline.stitcher_stc007) and the audio finishing chain
(pipeline.audio) — the reference's V2D -> L2B -> AP thread pipeline
(mainwindow.cpp:98-360) collapsed into a batch pipeline: devices decode
line batches ahead while the host stitches previous frames.

Port of sdvpcmdecoder_tpu/pipeline/full_decoder.py with an explicit
`device`: the frame's trial grid runs there, through the CUDA kernel's
wrapper (ops/fused_binarize) when `use_kernel` (the default on a GPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import binarize as bz
from ..ops import fused_binarize as fb
from . import audio as ap
from . import stitcher_stc007 as st
from .wav import WavWriter


class FullDecoder:
    """Frame-at-a-time STC-007 decoder with auto-stitching and masking."""

    def __init__(self, lines_per_field=294, order_hint=None,
                 mask_mode=ap.DROP_INTER_LIN_WORD, en_p=True, en_q=True,
                 en_cwd=False, hyst_limit=4, shift_limit=2, m2=False,
                 preset_video=None, device="cuda", use_kernel=None):
        self.device = torch.device(device)
        self.use_kernel = (self.device.type == "cuda" if use_kernel is None
                           else use_kernel)
        self.lines_per_field = lines_per_field
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self.m2 = m2
        if preset_video is None:
            preset_video = st.VID_PAL if lines_per_field == st.LINES_PF_PAL \
                else st.VID_NTSC
        self.stitcher = st.STC007Stitcher(
            en_p=en_p, en_q=en_q, en_cwd=en_cwd, mode_m2=m2,
            preset_video=preset_video,
            preset_order=order_hint or st.ORDER_UNK, device=self.device)
        self.audio = ap.AudioProcessor(mask_mode=mask_mode)
        self._first = True
        self._frame_no = 0

    def decode_frame_fields(self, pixels_fields, coords, black, white,
                            line_numbers):
        """Binarize one frame given as field-sequential line batch.

        pixels_fields [L, W] uint8 (field 1 lines then field 2 lines),
        coords [2] (shared for the frame), line_numbers [L].
        Returns a LineStore for the stitcher.
        """
        L, W = pixels_fields.shape
        ref = int(bz.pick_center_ref_level(np.array([black]),
                                           np.array([white]))[0][0])
        decode = fb.stc007_fused_decode_frames if self.use_kernel \
            else bz.stc007_frame_decode
        i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                        device=self.device)
        batch = decode(
            torch.from_numpy(np.ascontiguousarray(pixels_fields[None]))
            .to(self.device), i32([coords]), i32([ref]), i32([black]),
            i32([white]),
            hyst_limit=self.hyst_limit, shift_limit=self.shift_limit)
        self._frame_no += 1
        store = st.LineStore.from_decoded(
            batch.words[0].cpu().numpy(), batch.crc_read[0].cpu().numpy(),
            batch.valid[0].cpu().numpy(),
            np.full(L, self._frame_no), np.asarray(line_numbers),
            ref_level=np.full(L, int(ref)))
        if self._first:
            tag = st.LineStore(1)
            tag.service[0] = st.SRV_NEW_FILE
            tag.frame_number[0] = self._frame_no
            store = st.LineStore.concat([tag, store])
            self._first = False
        return store

    def push_frame(self, pixels_fields, coords, black=20, white=200,
                   line_numbers=None):
        L = pixels_fields.shape[0]
        if line_numbers is None:
            lpf = self.lines_per_field
            line_numbers = np.concatenate([
                1 + 2 * np.arange(min(L, lpf)),
                2 + 2 * np.arange(max(0, L - lpf))])
        store = self.decode_frame_fields(pixels_fields, coords, black,
                                         white, line_numbers)
        self.stitcher.push_frame(store)

    def finish(self):
        self.stitcher.finish()

    def collect(self, file_end=True):
        """Drain stitcher output through the audio chain.

        Returns (samples [N,2] int16, sample_rate) or (None, None).
        """
        arrs = st.chunks_to_arrays(self.stitcher.pop_sample_chunks())
        if arrs is None:
            if file_end:
                out = self.audio.flush()
                if len(out):
                    return out, 44100
            return None, None
        samples, word_valid, block_ok, rate = arrs
        out = self.audio.process(samples, word_valid, block_ok,
                                 file_end=file_end)
        return out, rate

    def decode_to_wav(self, frames_iter, path, coords, black=20, white=200):
        """Convenience: iterate (pixels_fields) frames -> WAV file."""
        writer = None
        for px in frames_iter:
            self.push_frame(px, coords, black, white)
        self.finish()
        samples, rate = self.collect()
        if samples is not None:
            writer = WavWriter(path, rate)
            writer.write(samples)
            writer.close()
        return samples
