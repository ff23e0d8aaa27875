"""Lazy windowed evaluation over long sequences (counterpart of
``pytorchcv_tpu.streaming.engine``; reference pytorchcv
``models/common/stream.py``).

The engine is host-side orchestration: it decides which window of the
source sequence(s) each model call sees, and keeps the results in a buffer
that grows on demand (``torch.cat`` on axis 0, on the results' device) and
that ``trim_buffer_to`` shortens once the consumer has passed a frame. With
``host_buffers`` the buffer and the sources are numpy arrays in host memory.
Windows run one at a time; batching same-shaped windows across cards waits
for the port of ``parallel/`` (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

__all__ = ["Sequencer", "BufferedSequencer", "WindowBufferedSequencer",
           "TensorSequencer", "WindowRange", "WindowMap", "WindowMultiMap",
           "calc_serial_window_sequencer_index",
           "calc_sliding_window_sequencer_index",
           "concat_window_sequencer_indices"]


@dataclasses.dataclass
class WindowRange:
    """Half-open [start, stop) range."""

    start: int
    stop: int

    def __repr__(self):
        return f"{self.start}:{self.stop}"


@dataclasses.dataclass
class WindowMap:
    """One window: target range produced from a source range, offset by
    ``target_start`` inside the window's raw output."""

    target: WindowRange
    source: WindowRange
    target_start: int

    def __repr__(self):
        return f"{self.target}:{self.target_start} <- {self.source}"


@dataclasses.dataclass
class WindowMultiMap:
    """Window with one source range per input sequence."""

    target: WindowRange
    sources: List[WindowRange]
    target_start: int

    def __repr__(self):
        srcs = "/".join(str(s) for s in self.sources)
        return f"{self.target}:{self.target_start} <- {srcs}"


WindowIndex = List[WindowMap]
WindowMultiIndex = List[WindowMultiMap]


def calc_serial_window_sequencer_index(length: int,
                                       target_length: int = None,
                                       window_size: int = 1,
                                       padding=(0, 0),
                                       edge_mode: str = "ignore"
                                       ) -> WindowIndex:
    """Tiled windows with halo ``padding``; ``edge_mode`` 'ignore' keeps
    edge outputs, 'trim' drops the halo at the sequence edges."""
    assert length > 0 and window_size > 0
    assert edge_mode in ("ignore", "trim")
    if target_length is None:
        target_length = length
    trim = padding if edge_mode == "trim" else (0, 0)
    index = []
    for i in range(0, target_length, window_size):
        src = WindowRange(max(i - padding[0], 0),
                          min(i + window_size + padding[1], length))
        t_start = max(i - trim[0], 0)
        t_stop = min(i - trim[0] + window_size,
                     target_length - trim[0] - trim[1])
        if edge_mode == "trim":
            offset = 0
        else:
            offset = i if i - padding[0] < 0 else padding[0]
        assert t_stop > t_start
        index.append(WindowMap(target=WindowRange(t_start, t_stop),
                               source=src, target_start=offset))
    return index


def calc_sliding_window_sequencer_index(length: int, stride: int = 1,
                                        src_padding=(0, 1),
                                        padding=(0, 1)) -> WindowIndex:
    """Overlapping windows advancing by ``stride``."""
    assert length > 0 and stride > 0
    pad_diff = max(padding[1] - src_padding[1], 0)
    index = []
    for i in range(0, length, stride):
        src = WindowRange(max(i - src_padding[0], 0),
                          min(i + src_padding[1], length - pad_diff))
        tgt = WindowRange(max(i - padding[0], 0),
                          min(i + padding[1], length))
        assert src.stop > src.start and tgt.stop > tgt.start
        index.append(WindowMap(target=tgt, source=src, target_start=0))
    return index


def concat_window_sequencer_indices(indices: List[WindowIndex]
                                    ) -> WindowMultiIndex:
    """Zip per-sequence window indices into one multi-source index."""
    return [WindowMultiMap(maps[0].target,
                           [m.source for m in maps],
                           maps[0].target_start)
            for maps in zip(*indices)]


def _to_host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class Sequencer:
    """Indexable calculator over source sequence(s): ``seq[a:b]`` maps the
    sources' [a:b] chunks through :meth:`_calc_data_items`."""

    def __init__(self, data):
        if isinstance(data, (tuple, list)):
            assert len(data) > 0
            self.raw_data_list = list(data)
        else:
            self.raw_data_list = [data]

    def __len__(self):
        return len(self.raw_data_list[0])

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 1
        return raw_data_chunk_list[0]

    def __getitem__(self, index):
        chunks = [raw[index] for raw in self.raw_data_list]
        return self._calc_data_items(chunks)


class BufferedSequencer(Sequencer):
    """Sequencer with a grow-on-demand result buffer. ``trim_buffer_to``
    drops results the consumer has passed (frees device memory);
    ``clear_buffer`` resets the stream. ``host_buffers=True`` keeps the
    buffer and the sources as numpy arrays in host memory."""

    def __init__(self, data, host_buffers: bool = False):
        super().__init__(data)
        self.start_pos = 0
        self.end_pos = 0
        self.buffer = None
        self.host_buffers = False
        if host_buffers:
            self.enable_host_buffers()

    def _to_buf(self, chunk):
        """Convert a freshly computed chunk to the buffer domain."""
        return _to_host(chunk) if self.host_buffers else chunk

    def _concat(self, chunks):
        if self.host_buffers:
            return np.concatenate(chunks, axis=0)
        return torch.cat(chunks, dim=0)

    def enable_host_buffers(self):
        """Switch to host-side buffering; converts any existing state."""
        self.host_buffers = True
        if self.buffer is not None:
            self.buffer = _to_host(self.buffer)
        self.raw_data_list = [
            raw if isinstance(raw, Sequencer) else _to_host(raw)
            for raw in self.raw_data_list]

    def _expand_buffer_by(self, data_chunk):
        self.buffer = self._concat([self.buffer, data_chunk])

    def _expand_buffer_to(self, end: int):
        assert end > self.end_pos
        chunks = [raw[self.end_pos:end] for raw in self.raw_data_list]
        data_chunk = self._to_buf(self._calc_data_items(chunks))
        if self.buffer is None:
            self.buffer = data_chunk
        else:
            self._expand_buffer_by(data_chunk)
        self.end_pos = end

    def __getitem__(self, index):
        if isinstance(index, slice):
            end = index.stop if index.stop is not None else len(self)
        else:
            end = index + 1
        if end > self.end_pos:
            self._expand_buffer_to(end=end)
        if isinstance(index, slice):
            if self.start_pos > 0:
                index = slice(
                    None if index.start is None
                    else index.start - self.start_pos,
                    None if index.stop is None
                    else index.stop - self.start_pos,
                    index.step)
            assert index.start is None or index.start >= 0
            assert index.stop is None or index.stop >= 0
        else:
            index -= self.start_pos
            assert index >= 0
        return self.buffer[index]

    def trim_buffer_to(self, start: int):
        assert 0 <= start < self.end_pos
        if start > self.start_pos:
            assert self.buffer is not None
            self.buffer = self.buffer[start - self.start_pos:]
            self.start_pos = start

    def clear_buffer(self):
        self.start_pos = 0
        self.end_pos = 0
        self.buffer = None


class WindowBufferedSequencer(BufferedSequencer):
    """Buffered sequencer whose target ranges are produced window by window
    from (multi-)source windows; ``_calc_data_items`` is the per-window
    model call. Windows run serially: ``mesh`` and ``window_batch > 1``
    (same-shaped windows as one batch sharded across cards) raise
    ``NotImplementedError`` until ``parallel/`` is ported (ROADMAP)."""

    def __init__(self, window_index, mesh=None, window_batch=None,
                 **kwargs):
        if mesh is not None or (window_batch is not None
                                and int(window_batch) > 1):
            raise NotImplementedError(
                "WindowBufferedSequencer: sharded window batches (mesh, "
                "window_batch > 1) wait for the port of parallel/ "
                "(ROADMAP.md, Still to port); run windows serially")
        super().__init__(**kwargs)
        assert len(window_index) > 0
        if isinstance(window_index[0], WindowMap):
            window_index = concat_window_sequencer_indices([window_index])
        self.window_index = window_index
        assert len(self.raw_data_list) == len(window_index[0].sources)
        self.length = window_index[-1].target.stop
        self.window_length = len(window_index)
        self.window_pos = -1

    def __len__(self):
        return self.length

    def _calc_window_pose(self, pos: int) -> int:
        for win_pos in range(max(self.window_pos + 1, 0),
                             self.window_length):
            if pos <= self.window_index[win_pos].target.stop:
                return win_pos
        return self.window_length - 1

    def _append_window_result(self, wmm, data_chunk):
        data_chunk = self._to_buf(data_chunk)
        span = wmm.target.stop - wmm.target.start
        if not (wmm.target_start == 0 and span == data_chunk.shape[0]):
            data_chunk = data_chunk[wmm.target_start:
                                    wmm.target_start + span]
        if self.buffer is None:
            self.buffer = data_chunk
        else:
            self._expand_buffer_by(data_chunk)
        self.end_pos = wmm.target.stop

    def _expand_buffer_to(self, end: int):
        assert end > self.end_pos
        win_end = self._calc_window_pose(end)
        for wp in range(max(self.window_pos + 1, 0), win_end + 1):
            wmm = self.window_index[wp]
            chunks = [raw[src.start:src.stop]
                      for raw, src in zip(self.raw_data_list, wmm.sources)]
            self._append_window_result(wmm, self._calc_data_items(chunks))
            self.window_pos = wp

    def clear_buffer(self):
        super().clear_buffer()
        self.window_pos = -1


class TensorSequencer(BufferedSequencer):
    """Identity buffered sequencer over a tensor (reference
    propainter_stream.py:462)."""

    def _calc_data_items(self, raw_data_chunk_list):
        assert len(raw_data_chunk_list) == 1
        return raw_data_chunk_list[0]
