"""Streaming ProPainter RFC: windowed flow completion over a video
(counterpart of ``pytorchcv_tpu.models.propainter_rfc_stream``; reference
pytorchcv ``models/propainter_rfc_stream.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels._build import no_tf32
from ..streaming import (WindowBufferedSequencer,
                         calc_serial_window_sequencer_index,
                         concat_window_sequencer_indices)
from .propainter_rfc import calc_bidirectional_opt_flow_completion_by_pprfc

__all__ = ["ProPainterRFCSequencer", "chunks_on", "model_device"]


def _resolve_apply(model, name: str):
    """A module or a callable as given; None builds the registered model
    ``name`` on the card (JAX ``models/raft_stream.py:17``)."""
    if model is None:
        from ..model_provider import get_model
        model = get_model(name)
    return model


def model_device(model) -> Optional[torch.device]:
    """The device of a module's first parameter; None for a callable."""
    if isinstance(model, nn.Module):
        return next(model.parameters()).device
    return None


def chunks_on(chunks, device: Optional[torch.device], who: str):
    """A window's source chunks as tensors on ``device``: numpy chunks
    (``host_buffers``) are copied there, a tensor on another device raises.
    ``device`` None takes the chunks as they are."""
    out = []
    for chunk in chunks:
        if not torch.is_tensor(chunk):
            chunk = torch.from_numpy(chunk)
            chunk = chunk if device is None else chunk.to(device)
        elif device is not None and chunk.device != device:
            raise ValueError(f"{who}: data on {chunk.device}, model on "
                             f"{device}")
        out.append(chunk)
    return out


class ProPainterRFCSequencer(WindowBufferedSequencer):
    """Flow completion window by window (JAX
    ``propainter_rfc_stream.py:17``). Sources: ``flows`` (T-1, 4, H, W)
    and ``masks`` (T, 1, H, W); it produces completed flows (T-1, 4, H, W).
    Each window runs under ``torch.inference_mode`` in f32 with TF32 off
    (``no_tf32``) on the model's device; a tensor on another device raises,
    numpy chunks (``host_buffers``) are copied there."""

    def __init__(self, flows, masks, pprfc_model=None,
                 window_size: int = 80, padding: int = 5, **kwargs):
        assert len(masks) > 0
        super().__init__(
            data=[flows, masks],
            window_index=self._calc_window_index(
                video_length=len(masks), window_size=window_size,
                padding=padding),
            **kwargs)
        self.net = _resolve_apply(pprfc_model, "propainter_rfc")

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 2
        flows, masks = chunks_on(raw_data_chunk_list, model_device(self.net),
                                 "ProPainterRFCSequencer")
        flow_masks = torch.cat([masks[:-1], masks[1:]], dim=1)
        with torch.inference_mode(), no_tf32():
            comp_flows, _ = calc_bidirectional_opt_flow_completion_by_pprfc(
                self.net, flows, flow_masks)
        return comp_flows

    @staticmethod
    def _calc_window_index(video_length, window_size, padding):
        assert window_size > 0
        flows_index = calc_serial_window_sequencer_index(
            length=video_length - 1, target_length=video_length,
            window_size=window_size, padding=(padding, padding),
            edge_mode="ignore")
        mask_index = calc_serial_window_sequencer_index(
            length=video_length, target_length=video_length,
            window_size=window_size, padding=(padding, padding + 1),
            edge_mode="ignore")
        return concat_window_sequencer_indices([flows_index, mask_index])
