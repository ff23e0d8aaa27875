"""Streaming ProPainter: the video-inpainting pipeline as lazily evaluated,
windowed sequencers (counterpart of ``pytorchcv_tpu.models.propainter_stream``;
reference pytorchcv ``models/propainter_stream.py``). RAFT's bidirectional
flows (``RAFTSequencer``) go through flow completion
(``ProPainterRFCSequencer``); image propagation (``ProPainterIPSequencer``)
feeds the generator (``ProPainterITSequencer``, stride-5 windows of 11 local
frames and up to 9 references, overlaps averaged), whose frames the mask
blend (``ProPainterIMSequencer``) pastes into the input.
``ProPainterIterator`` wires the five from raw frames and masks and hands
out inpainted frames in chunks, each stage's buffer trimmed as the consumer
passes, so memory stays a few windows whatever the video's length.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels._build import no_tf32
from ..model_provider import resolve_device
from ..streaming import (BufferedSequencer, Sequencer, TensorSequencer,
                         WindowBufferedSequencer,
                         calc_sliding_window_sequencer_index,
                         concat_window_sequencer_indices)
from .propainter_ip_stream import ProPainterIPSequencer
from .propainter_rfc_stream import (ProPainterRFCSequencer, _resolve_apply,
                                    chunks_on, model_device)
from .raft_stream import RAFTSequencer

__all__ = ["ProPainterITSequencer", "ProPainterIMSequencer",
           "ProPainterIPSequencer", "ProPainterIterator", "TensorSequencer"]


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
    builds ``propainter`` on ``device``, by default the card); a tensor on
    another device raises, numpy chunks are copied there."""

    def __init__(self, prop_framemasks, masks, comp_flows, pp_model=None,
                 pp_stride: int = 5, pp_ref_stride: int = 10,
                 pp_ref_window_size: int = 80, device=None, **kwargs):
        assert len(masks) > 0
        super().__init__(
            data=[prop_framemasks, masks, comp_flows],
            window_index=self._calc_window_index(
                video_length=len(masks), pp_stride=pp_stride,
                pp_ref_window_size=pp_ref_window_size),
            **kwargs)
        self.net = _resolve_apply(pp_model, "propainter", device)
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


class ProPainterIterator:
    """Video inpainting end to end from raw frames (JAX
    ``propainter_stream.py:151``): iterating yields the inpainted frames
    (``step``, 3, H, W) chunk by chunk, the last chunk shorter.

    ``frames`` (T, 3, H, W) in [-1, 1] and ``masks`` (T, 1, H, W) of 1
    where a pixel is to be filled, each a ``BufferedSequencer`` (such as
    ``TensorSequencer``). RAFT's flows (``raft_model``, window
    ``raft_window_size`` or by the frame size) go through flow completion
    (``pprfc_model``, windows of ``pp_window_size``), image propagation and
    the generator (``pp_model``, references within ``pp_window_size`` / 2),
    then the mask blend. A model left None is built by name on ``device``
    (default: the card), where image propagation also runs. After each
    chunk every stage's buffer is trimmed: generated frames, completed
    flows, flows and frames to 2 frames before the chunk's end, propagated
    frames and masks to ``pp_window_size`` / 2 - ``pp_stride``. With
    ``host_buffers`` the buffers and the chunks are numpy arrays in host
    memory, and each window's sources are copied to the models' device."""

    def __init__(self, frames: BufferedSequencer, masks: BufferedSequencer,
                 raft_model=None, pprfc_model=None, pp_model=None,
                 raft_window_size: Optional[int] = None,
                 pp_window_size: int = 80, pp_stride: int = 5,
                 step: int = 10, host_buffers: bool = False, device=None):
        assert len(frames) > 0 and len(frames) == len(masks) and step > 0
        assert isinstance(frames, BufferedSequencer)
        assert isinstance(masks, BufferedSequencer)
        self.video_length = len(frames)
        self.step = step
        self.frames = frames
        self.masks = masks
        if host_buffers:
            frames.enable_host_buffers()
            masks.enable_host_buffers()
        device = resolve_device(device)
        self.flow_sequencer = RAFTSequencer(
            frames=frames, raft_model=raft_model,
            window_size=raft_window_size, device=device,
            host_buffers=host_buffers)
        self.comp_flow_sequencer = ProPainterRFCSequencer(
            flows=self.flow_sequencer, masks=masks,
            pprfc_model=pprfc_model, window_size=pp_window_size,
            device=device, host_buffers=host_buffers)
        self.prop_framemask_sequencer = ProPainterIPSequencer(
            frames=frames, masks=masks,
            comp_flows=self.comp_flow_sequencer,
            window_size=pp_window_size, device=device,
            host_buffers=host_buffers)
        self.trans_frame_sequencer = ProPainterITSequencer(
            prop_framemasks=self.prop_framemask_sequencer, masks=masks,
            comp_flows=self.comp_flow_sequencer, pp_model=pp_model,
            pp_ref_window_size=pp_window_size, device=device,
            host_buffers=host_buffers)
        self.inp_frame_sequencer = ProPainterIMSequencer(
            trans_frames=self.trans_frame_sequencer, frames=frames,
            masks=masks)
        self.main_sequencer = self.inp_frame_sequencer
        self.trans_frame_trim_pad = 2
        self.prop_framemask_trim_pad = pp_window_size // 2 - pp_stride
        self.comp_flow_trim_pad = 2
        self.flow_trim_pad = 2
        self.mask_trim_pad = pp_window_size // 2 - pp_stride
        self.frame_trim_pad = 2

    def __iter__(self):
        self.s = -self.step
        self.trans_frame_sequencer.clear_buffer()
        self.prop_framemask_sequencer.clear_buffer()
        self.comp_flow_sequencer.clear_buffer()
        self.flow_sequencer.clear_buffer()
        self.masks.clear_buffer()
        self.frames.clear_buffer()
        return self

    def __next__(self):
        if self.s is None:
            raise StopIteration
        self.s = min(self.s + self.step, self.video_length - 1)
        e = min(self.s + self.step, self.video_length)
        data = self.main_sequencer[self.s:e]
        self.trans_frame_sequencer.trim_buffer_to(
            max(e - self.trans_frame_trim_pad, 0))
        self.prop_framemask_sequencer.trim_buffer_to(
            max(e - self.prop_framemask_trim_pad, 0))
        self.comp_flow_sequencer.trim_buffer_to(
            max(e - self.comp_flow_trim_pad, 0))
        self.flow_sequencer.trim_buffer_to(max(e - self.flow_trim_pad, 0))
        self.masks.trim_buffer_to(max(e - self.mask_trim_pad, 0))
        self.frames.trim_buffer_to(max(e - self.frame_trim_pad, 0))
        if e == self.video_length:
            self.s = None
        return data
