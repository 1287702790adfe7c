"""Flat re-export of the common API surface (``src/prelude.rs`` analog).

Hello-world (the compiled-path analog of the reference's front-page
doc-test, ``src/lib.rs:13-36``): declare a chain, bind it to a stream
signature, process chunk batches through one fused XLA program:

>>> import numpy as np
>>> sig = StreamSig(batch=1, chunk_len=16, sample_rate=48000.0)
>>> chain = Chain(GainControl(0.5), FreqShifter.with_shift(0.0)).bind(sig)
>>> state = chain.init_state()
>>> x = np.ones((1, 16), np.complex64)
>>> state, y = chain.process(chain.params, state, x, np.asarray([False]))
>>> complex(np.asarray(y)[0, 0])
(0.5+0j)
"""

from .blocks.analysis import Fourier
from .blocks.base import (Block, BoundBlock, Chain, StreamSig, jit_step,
                          make_scan, pack_wire, scan, unpack_wire)
from .blocks.channelize import Channelizer
from .blocks.chunks import Overlapper, rechunk
from .blocks.filters import (Filter, FilterBank, SlewRateLimiter,
                             deemphasis_factor)
from .blocks.graph import BoundGraph, Graph, graph_scan
from .blocks.modulation import FmDemod, FmMod
from .blocks.morse import Keyer, Speed, encode
from .blocks.resampling import Downsampler, Upsampler
from .blocks.transform import (AgcControl, Combine, FreqShifter,
                               GainControl, MapSample, Squelch)
from .metering import bandwidth, bandwidth_jax, level, level_jax, \
    rescale_energy, rescale_energy_jax
from .signal import (BufferOverflow, Disconnection, Event, Samples,
                     SamplesLost, Warmup)
from .windowing import CustomWindow, Kaiser, Rectangular, Window

__all__ = [
    "Block", "BoundBlock", "Chain", "StreamSig", "jit_step", "make_scan",
    "scan", "pack_wire", "unpack_wire",
    "Fourier", "Channelizer", "Overlapper", "rechunk",
    "Filter", "FilterBank", "SlewRateLimiter", "deemphasis_factor",
    "Graph", "BoundGraph", "graph_scan",
    "FmDemod", "FmMod", "Keyer", "Speed", "encode",
    "Downsampler", "Upsampler", "FreqShifter", "GainControl",
    "AgcControl", "Squelch", "MapSample",
    "Combine",
    "bandwidth", "bandwidth_jax", "level", "level_jax",
    "rescale_energy", "rescale_energy_jax",
    "Event", "Samples", "Disconnection", "SamplesLost", "BufferOverflow",
    "Warmup",
    "Kaiser", "Rectangular", "CustomWindow", "Window",
]
