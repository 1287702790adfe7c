"""Wideband FM receive chain — the north-star pipeline.

Rebuilds the reference's WFM receiver
(``examples/relm_app/simple_receiver.rs:14-71``) as one compiled chain:

    IQ 1.024 Msps [batch, 16384]
      -> FreqShifter (tune)
      -> Downsampler to 384 kHz (bw 200 kHz)     [chunk 6144]
      -> Filter low-pass +-100 kHz
      -> FmDemod (deviation 150 kHz)
      -> Filter rectangular: deemphasis 50 us, DC block, 20 Hz - 16 kHz
      -> Downsampler to 48 kHz (bw 40 kHz)       [chunk 768]
      -> GainControl (volume)

The whole chain jits into a single XLA program per chunk step; ``batch``
carries independent receivers (channels) through the same program.
"""

from __future__ import annotations

import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter, deemphasis_factor
from ..blocks.modulation import FmDemod
from ..blocks.resampling import Downsampler
from ..blocks.transform import FreqShifter, GainControl

__all__ = ["wfm_receiver", "wfm_receiver_graph", "wfm_transmitter",
           "WFM_INPUT_RATE", "WFM_INPUT_CHUNK", "WFM_AUDIO_RATE",
           "WFM_AUDIO_CHUNK"]

WFM_INPUT_RATE = 1024000.0
WFM_INPUT_CHUNK = 16384
WFM_AUDIO_RATE = 48000.0
WFM_AUDIO_CHUNK = 768


def _lowpass_100k(bins, freqs):
    return np.where(np.abs(freqs) <= 100000.0, 1.0 + 0.0j, 0.0j)


def _deemphasis_band(bins, freqs):
    # examples/relm_app/simple_receiver.rs:43-50: DC block (|bin| >= 1),
    # 20 Hz..16 kHz band, 50 us deemphasis.
    keep = (np.abs(bins) >= 1) & (np.abs(freqs) >= 20.0) \
        & (np.abs(freqs) <= 16000.0)
    return np.where(keep, deemphasis_factor(50e-6, freqs), 0.0j)


def _preemphasis_band(bins, freqs):
    # Inverse of the receiver's deemphasis inside the audio band, so a
    # TX -> RX roundtrip is spectrally flat over 20 Hz - 16 kHz.
    keep = (np.abs(bins) >= 1) & (np.abs(freqs) >= 20.0) \
        & (np.abs(freqs) <= 16000.0)
    return np.where(keep, 1.0 / deemphasis_factor(50e-6, freqs), 0.0j)


def wfm_transmitter(deviation: float = 150000.0,
                    gain: float = 1.0) -> Chain:
    """WFM broadcast transmitter: the receive chain's inverse.

    The reference has no WFM TX example, but all its pieces are reference
    blocks (``FmMod`` ``src/blocks/modulation.rs:13-80``, ``Upsampler``
    ``src/blocks/resampling.rs:149-280``, preemphasis = inverse of
    ``examples/relm_app/simple_receiver.rs:43-50``'s deemphasis):

        audio 48 kHz [batch, 768]
          -> Filter rectangular: preemphasis 50 us, 20 Hz - 16 kHz band
          -> GainControl (modulation depth)
          -> Upsampler to 1.024 MHz (bw 40 kHz)   [chunk 16384]
          -> FmMod (deviation 150 kHz)

    Output is 1.024 Msps IQ, chunk-compatible with :func:`wfm_receiver`
    (roundtrip-tested in tests/test_models.py).
    """
    from ..blocks.modulation import FmMod
    from ..blocks.resampling import Upsampler
    return Chain(
        Filter.new_rectangular(_preemphasis_band),
        GainControl(gain),
        Upsampler(WFM_INPUT_RATE, 2.0 * 20000.0),
        FmMod(deviation),
    )


def wfm_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                 deviation: float = 150000.0,
                 fuse_deemphasis: bool = False,
                 filter_ir_len=None) -> Chain:
    """The WFM receive chain as a composable block spec.

    ``fuse_deemphasis=True`` folds the deemphasis filter's impulse response
    into the final decimating FIR (an exact LTI composition).  The default
    keeps the literal block-for-block chain of the reference.

    ``filter_ir_len`` decouples the two overlap-save filters' IR length
    from the mid-chain chunk (decoupled geometry, blocks/filters.py):
    binding at a larger input chunk with ``filter_ir_len=6144`` keeps the
    reference's designed responses (62.5 Hz resolution at 384 kHz) while
    each step processes more new samples per transform — e.g. input
    chunk 24576 gives a mid chunk of 9216 over 15360-point transforms.
    At the default 16384-chunk binding, ``filter_ir_len=6144`` equals the
    coupled geometry exactly.
    """
    from ..windowing import Rectangular
    irl = filter_ir_len
    head = [FreqShifter.with_shift(tune_shift),
            Downsampler(384000.0, 200000.0)]
    mid = [Filter.new(_lowpass_100k, ir_len=irl), FmDemod(deviation)]
    if fuse_deemphasis:
        tail = [Downsampler(48000.0, 2.0 * 20000.0,
                            prefilter=(_deemphasis_band, Rectangular()))]
    else:
        tail = [Filter.new_rectangular(_deemphasis_band, ir_len=irl),
                Downsampler(48000.0, 2.0 * 20000.0)]
    return Chain(
        *head,
        *mid,
        *tail,
        GainControl(volume),
    )


def wfm_receiver_graph(tune_shift: float = 0.0, volume: float = 1.0,
                       deviation: float = 150000.0, quality: int = 4):
    """WFM receiver with a live spectrum tap, as one compiled DAG.

    The reference gets this shape by broadcasting one producer to several
    consumers in lock-step (``src/flow.rs:44-52``) — e.g. playing audio
    while an analysis chain like ``examples/bandwidth_meter/main.rs:54-68``
    observes the same tuned stream.  Here both consumers share the tuned,
    channel-filtered front end *inside one XLA program*:

        iq -> shift -> decimate 384k -> LPF +-100k
               |-> demod -> deemphasis -> decimate 48k -> gain  = "audio"
               '-> Overlapper(q) -> Fourier(Kaiser)             = "spectrum"

    Returns a :class:`radiorust_tpu.blocks.graph.Graph`; bind with the
    usual WFM input signature.
    """
    from ..blocks.analysis import Fourier
    from ..blocks.chunks import Overlapper
    from ..blocks.graph import Graph
    from ..windowing import Kaiser

    g = Graph()
    iq = g.input("iq")
    tuned = g.chain([FreqShifter.with_shift(tune_shift),
                     Downsampler(384000.0, 200000.0),
                     Filter.new(_lowpass_100k)], iq)
    g.output("audio", g.chain([
        FmDemod(deviation),
        Filter.new_rectangular(_deemphasis_band),
        Downsampler(48000.0, 2.0 * 20000.0),
        GainControl(volume)], tuned))
    g.output("spectrum", g.chain([
        Overlapper(quality),
        Fourier.with_window(Kaiser.with_null_at_bin(float(quality)))],
        tuned))
    return g
