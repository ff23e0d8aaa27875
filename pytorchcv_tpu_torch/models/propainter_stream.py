"""Streaming ProPainter, stages 3-5 of the video inpainting pipeline as
lazily evaluated, windowed sequencers (counterpart of
``pytorchcv_tpu.models.propainter_stream``; reference pytorchcv
``models/propainter_stream.py``): image propagation
(``ProPainterIPSequencer``) feeds the generator (``ProPainterITSequencer``,
stride-5 windows of 11 local frames and up to 9 references, overlaps
averaged), whose frames the mask blend (``ProPainterIMSequencer``) pastes
into the input. ``ProPainterIterator``, which also runs RAFT and flow
completion, waits for the port of RAFT (ROADMAP).
"""

from __future__ import annotations

import torch

from ..kernels._build import no_tf32
from ..streaming import (Sequencer, WindowBufferedSequencer,
                         calc_sliding_window_sequencer_index,
                         concat_window_sequencer_indices)
from .propainter_ip_stream import ProPainterIPSequencer
from .propainter_rfc_stream import _resolve_apply, chunks_on, model_device

__all__ = ["ProPainterITSequencer", "ProPainterIMSequencer",
           "ProPainterIPSequencer"]


class ProPainterITSequencer(WindowBufferedSequencer):
    """The generator over stride-``pp_stride`` sliding windows (JAX
    ``propainter_stream.py:29``). Sources: ``prop_framemasks`` (T, 4, H, W)
    from image propagation, ``masks`` (T, 1, H, W) and ``comp_flows``
    (T-1, 4, H, W); it produces generated frames (T, 3, H, W). A window's
    local frames are the 2 ``pp_stride`` + 1 around its position, its
    references every ``pp_ref_stride``-th frame within
    ``pp_ref_window_size`` / 2 of it; where windows overlap the results
    are averaged. Each window runs under ``torch.inference_mode`` in f32
    with TF32 off (``no_tf32``) on the model's device (``pp_model`` None
    builds ``propainter`` on the card); a tensor on another device raises,
    numpy chunks are copied there."""

    def __init__(self, prop_framemasks, masks, comp_flows, pp_model=None,
                 pp_stride: int = 5, pp_ref_stride: int = 10,
                 pp_ref_window_size: int = 80, **kwargs):
        assert len(masks) > 0
        super().__init__(
            data=[prop_framemasks, masks, comp_flows],
            window_index=self._calc_window_index(
                video_length=len(masks), pp_stride=pp_stride,
                pp_ref_window_size=pp_ref_window_size),
            **kwargs)
        self.net = _resolve_apply(pp_model, "propainter")
        self.stride = pp_stride
        self.ref_stride = pp_ref_stride
        self.num_refs = pp_ref_window_size // pp_ref_stride

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 3
        prop_framemasks, masks, comp_flows = chunks_on(
            raw_data_chunk_list, model_device(self.net),
            "ProPainterITSequencer")
        win_pos = self.window_pos + 1
        s_idx = win_pos * self.stride
        neighbor_ids = self._calc_neighbor_index(s_idx, self.length,
                                                 self.stride)
        ref_ids = self._calc_ref_index(s_idx, neighbor_ids, self.length,
                                       self.ref_stride, self.num_refs)
        start = self.window_index[win_pos].sources[0].start
        ids = torch.as_tensor([i - start for i in neighbor_ids + ref_ids],
                              device=prop_framemasks.device)
        frames = prop_framemasks[ids]
        l_t = len(comp_flows) + 1
        with torch.inference_mode(), no_tf32():
            trans_frames = self.net(frames[None, :, :3], frames[None, :, 3:],
                                    masks[ids][None], comp_flows[None], l_t)
        return trans_frames[0]

    def _calc_window_pose(self, pos: int) -> int:
        # windows overlap: advance only when pos passes a window's target
        # start (reference propainter_stream.py:118)
        for win_pos in range(max(self.window_pos + 1, 0),
                             self.window_length):
            if pos <= self.window_index[win_pos].target.start:
                assert win_pos > 0
                return win_pos - 1
        return self.window_length - 1

    def _expand_buffer_by(self, data_chunk):
        # average the overlap with the buffer's tail
        wmm = self.window_index[self.window_pos + 1]
        assert wmm.target_start == 0
        s = wmm.target.start - self.start_pos
        assert 0 <= s <= len(self.buffer)
        if s == len(self.buffer):
            self.buffer = self._concat([self.buffer, data_chunk])
        else:
            tail_len = len(self.buffer) - s
            assert tail_len <= len(data_chunk)
            blended = 0.5 * (self.buffer[s:] + data_chunk[:tail_len])
            self.buffer = self._concat(
                [self.buffer[:s], blended, data_chunk[tail_len:]])

    @staticmethod
    def _calc_neighbor_index(mid, length, stride):
        return list(range(max(0, mid - stride),
                          min(length, mid + stride + 1)))

    @staticmethod
    def _calc_ref_index(mid, neighbor_ids, length, ref_stride, ref_num):
        ref_index = []
        if ref_num == -1:
            for i in range(0, length, ref_stride):
                if i not in neighbor_ids:
                    ref_index.append(i)
        else:
            start = max(0, mid - ref_stride * (ref_num // 2))
            end = min(length, mid + ref_stride * (ref_num // 2))
            for i in range(start, end, ref_stride):
                if i not in neighbor_ids:
                    if len(ref_index) > ref_num:
                        break
                    ref_index.append(i)
        return ref_index

    @staticmethod
    def _calc_window_index(video_length, pp_stride, pp_ref_window_size):
        assert pp_ref_window_size % 2 == 0
        ref_index = calc_sliding_window_sequencer_index(
            length=video_length, stride=pp_stride,
            src_padding=(pp_ref_window_size // 2,
                         pp_ref_window_size // 2 + 1),
            padding=(pp_stride, pp_stride + 1))
        flows_index = calc_sliding_window_sequencer_index(
            length=video_length, stride=pp_stride,
            src_padding=(pp_stride, pp_stride),
            padding=(pp_stride, pp_stride + 1))
        return concat_window_sequencer_indices(
            [ref_index, ref_index, flows_index])


class ProPainterIMSequencer(Sequencer):
    """The mask blend: generated pixels inside the masks, the input frames
    outside (JAX ``propainter_stream.py:137``). Sources: generated frames
    (T, 3, H, W), frames (T, 3, H, W), masks (T, 1, H, W)."""

    def __init__(self, trans_frames, frames, masks):
        assert len(frames) > 0
        super().__init__(data=[trans_frames, frames, masks])

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 3
        trans_frames, frames, masks = raw_data_chunk_list
        return trans_frames * masks + frames * (1 - masks)
