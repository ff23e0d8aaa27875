"""Streaming ProPainter image propagation: windowed pixel propagation over
a video (counterpart of ``pytorchcv_tpu.models.propainter_ip_stream``;
reference pytorchcv ``models/propainter_ip_stream.py``)."""

from __future__ import annotations

import torch

from ..kernels._build import no_tf32
from ..model_provider import get_model, resolve_device
from ..streaming import (WindowBufferedSequencer,
                         calc_serial_window_sequencer_index,
                         concat_window_sequencer_indices)
from .propainter_rfc_stream import chunks_on

__all__ = ["ProPainterIPSequencer"]


class ProPainterIPSequencer(WindowBufferedSequencer):
    """Image propagation window by window (JAX
    ``propainter_ip_stream.py:17``). Sources: ``frames`` (T, 3, H, W),
    ``masks`` (T, 1, H, W) and ``comp_flows`` (T-1, 4, H, W); it produces
    propagated frames and updated masks, (T, 4, H, W). The model has no
    parameters, so it runs on ``device``: the card unless the caller asks
    for another. Each window runs under ``torch.inference_mode`` with TF32
    off (``no_tf32``); a tensor on another device raises, numpy chunks
    (``host_buffers``) are copied there."""

    def __init__(self, frames, masks, comp_flows, window_size: int = 80,
                 padding: int = 10, device=None, **kwargs):
        assert len(frames) > 0
        super().__init__(
            data=[frames, masks, comp_flows],
            window_index=self._calc_window_index(
                video_length=len(masks), window_size=window_size,
                padding=padding),
            **kwargs)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.net = get_model("propainter_ip", device=dev)

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 3
        frames, masks, comp_flows = chunks_on(
            raw_data_chunk_list, self.device, "ProPainterIPSequencer")
        with torch.inference_mode(), no_tf32():
            prop_frames, updated_masks = self.net(
                frames, masks, comp_flows, interpolation="nearest")
        return torch.cat([prop_frames, updated_masks], dim=1)

    @staticmethod
    def _calc_window_index(video_length, window_size, padding):
        assert window_size > 0
        images_index = calc_serial_window_sequencer_index(
            length=video_length, target_length=video_length,
            window_size=window_size, padding=(padding, padding),
            edge_mode="ignore")
        flows_index = calc_serial_window_sequencer_index(
            length=video_length - 1, target_length=video_length,
            window_size=window_size, padding=(padding, padding - 1),
            edge_mode="ignore")
        return concat_window_sequencer_indices(
            [images_index, images_index, flows_index])
