"""Multi-channel wideband receiver: 64-way channelize + per-channel FM.

The scaled-up headline workload (BASELINE.json config 5): a wideband IQ
stream splits into 64 critically sampled channels via one polyphase FFT
filterbank, then every channel runs an FM demodulation chain — all in one
compiled program, channels riding the batch axis.  Sharding: time axis via
:class:`radiorust_tpu.parallel.time_shard.TimeShardedChain` with halo
exchange, channels/batch via the mesh channel axis.
"""

from __future__ import annotations

from ..blocks.base import Chain
from ..blocks.channelize import Channelizer
from ..blocks.modulation import FmDemod
from ..blocks.transform import GainControl

__all__ = ["channelized_receiver"]


def channelized_receiver(num_channels: int = 64,
                         taps_per_branch: int = 8,
                         deviation_fraction: float = 0.25,
                         input_rate: float = 16384000.0) -> Chain:
    """Channelize -> per-channel quadrature FM demod -> gain.

    ``deviation_fraction`` scales the per-channel FM deviation relative to
    the channel bandwidth (``input_rate / num_channels``).
    """
    channel_rate = input_rate / num_channels
    deviation = deviation_fraction * channel_rate
    return Chain(
        Channelizer(num_channels, taps_per_branch),
        FmDemod(deviation),
        GainControl(1.0),
    )
