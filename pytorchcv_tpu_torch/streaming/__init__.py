"""Streaming engine: lazy windowed evaluation over long sequences
(counterpart of ``pytorchcv_tpu.streaming``)."""

from .engine import (BufferedSequencer, Sequencer, TensorSequencer,
                     WindowBufferedSequencer, WindowMap, WindowMultiMap,
                     WindowRange, calc_serial_window_sequencer_index,
                     calc_sliding_window_sequencer_index,
                     concat_window_sequencer_indices)

__all__ = ["BufferedSequencer", "Sequencer", "TensorSequencer",
           "WindowBufferedSequencer", "WindowMap", "WindowMultiMap",
           "WindowRange", "calc_serial_window_sequencer_index",
           "calc_sliding_window_sequencer_index",
           "concat_window_sequencer_indices"]
