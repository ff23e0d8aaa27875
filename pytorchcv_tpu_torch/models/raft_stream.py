"""Streaming RAFT: windowed bidirectional optical flow over a video
(counterpart of ``pytorchcv_tpu.models.raft_stream``; reference pytorchcv
``models/raft_stream.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels._build import no_tf32
from ..streaming import (WindowBufferedSequencer,
                         calc_serial_window_sequencer_index)
from .propainter_rfc_stream import _resolve_apply, chunks_on, model_device
from .raft import calc_bidirectional_optical_flow_on_video_by_raft

__all__ = ["RAFTSequencer"]


class RAFTSequencer(WindowBufferedSequencer):
    """Optical flow window by window (JAX ``raft_stream.py:49``). Source:
    ``frames`` (T, 3, H, W) in [-1, 1]; it produces bidirectional flows
    (T-1, 4, H, W), channels (fwd_x, fwd_y, bwd_x, bwd_y). A window is
    ``window_size`` frames (by default from the frame size: 12 up to 640
    px, 8 up to 720, 4 up to 1280, 2 up to 1980, else 1) and the frame
    before it. ``raft_model`` None builds ``raft_things`` with
    ``in_normalize=False, iters=raft_iters`` on ``device`` (default: the
    card). Each window runs under ``torch.inference_mode`` in f32 with TF32
    off (``no_tf32``) on the model's device; a tensor on another device
    raises, numpy chunks (``host_buffers``) are copied there."""

    def __init__(self, frames, raft_model=None, raft_iters: int = 20,
                 window_size: Optional[int] = None, device=None, **kwargs):
        assert len(frames) > 1
        super().__init__(
            data=frames,
            window_index=self._calc_window_index(
                video_length=len(frames), window_size=window_size,
                frame_size=tuple(frames[0].shape[-2:])),
            **kwargs)
        self.net = _resolve_apply(raft_model, "raft_things", device,
                                  in_normalize=False, iters=raft_iters)

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 1
        frames, = chunks_on(raw_data_chunk_list, model_device(self.net),
                            "RAFTSequencer")
        with torch.inference_mode(), no_tf32():
            return calc_bidirectional_optical_flow_on_video_by_raft(
                self.net, frames)

    @staticmethod
    def _calc_window_index(video_length, window_size, frame_size):
        return calc_serial_window_sequencer_index(
            length=video_length, target_length=video_length,
            window_size=RAFTSequencer._calc_window_size(window_size,
                                                        frame_size),
            padding=(1, 0), edge_mode="trim")

    @staticmethod
    def _calc_window_size(window_size, frame_size):
        """``window_size`` where given, else by the frame's larger side
        (JAX ``raft_stream.py:82``; reference ``raft_stream.py:180``)."""
        if window_size is not None:
            assert window_size > 0
            return window_size
        m = max(frame_size[0], frame_size[1])
        if m <= 640:
            return 12
        if m <= 720:
            return 8
        if m <= 1280:
            return 4
        if m <= 1980:
            return 2
        return 1
