"""WFM *stereo* receiver — beyond the reference (which is mono-only).

The reference's WFM example demodulates the composite (MPX) baseband and
plays it as mono (``examples/relm_app/simple_receiver.rs:40-53``).  The
broadcast MPX actually carries

    0-15 kHz     (L+R)/2                  (the mono program)
    19 kHz       pilot tone (~10%)
    23-53 kHz    (L-R)/2 DSB-SC on 38 kHz (2x the pilot, phase-locked)

This model decodes it with a *filter-bank + analytic-carrier* method that
is pure dataflow — no PLL, no per-sample feedback — so it compiles into
the same one fused XLA program as everything else:

1. one-sided (analytic) band-pass 18.4-19.6 kHz -> ``p ~ A e^{j(wt+phi)}``,
2. ``p^2 / |p|^2`` -> exact unit-amplitude 38 kHz carrier ``e^{j2(wt+phi)}``
   (squaring doubles the phase; normalizing strips the amplitude),
3. one-sided band-pass 23-53 kHz -> analytic subcarrier
   ``s = (L-R)/2 e^{j2(wt+phi)}`` (exact: the band is clear of overlap),
4. ``Re(s conj(carrier)) = (L-R)/2``; matrix with the 0-15 kHz low-pass
   ``(L+R)/2`` into L and R.

L and R ride one complex stream as ``L + jR``: the downstream deemphasis
filter and 48 kHz decimator have real impulse responses, which act on the
real and imaginary planes independently, so one chain processes both
audio channels for free.  All three analysis filters share the same
chunk length, hence the same group delay — the paths stay sample-aligned
by construction and the matrix needs no realignment.

Fan-in (the carrier mix and the L/R matrix) uses
:class:`~radiorust_tpu.blocks.transform.Combine` graph nodes.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..blocks.filters import Filter, FilterBank
from ..blocks.graph import Graph, NodeRef
from ..blocks.modulation import FmDemod
from ..blocks.resampling import Downsampler
from ..blocks.transform import Combine, FreqShifter, GainControl, MapSample
from .wfm import WFM_AUDIO_RATE, _deemphasis_band, _lowpass_100k

__all__ = ["wfm_stereo_receiver", "stereo_mpx_decoder",
           "PILOT_FREQ", "MPX_RATE"]

PILOT_FREQ = 19000.0
MPX_RATE = 384000.0


def _mono_band(bins, freqs):
    return np.where(np.abs(freqs) <= 15000.0, 1.0 + 0.0j, 0.0j)


def _pilot_band(bins, freqs):
    # One-sided (positive frequencies only) -> analytic signal; the x2
    # restores the cosine's amplitude in the analytic representation.
    keep = (freqs >= PILOT_FREQ - 600.0) & (freqs <= PILOT_FREQ + 600.0)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def _subcarrier_band(bins, freqs):
    keep = (freqs >= 23000.0) & (freqs <= 53000.0)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def _double_phase(z):
    # z^2/|z|^2: doubles the phase angle, normalizes the amplitude.  The
    # epsilon only matters while the pilot filter is still warming up
    # (|p| ~ 0.1 in steady state); it decays the carrier to 0 -> mono.
    return z * z * (1.0 / (jnp.abs(z) ** 2 + 1e-12))


def _mix_subcarrier(s, c):
    return s * jnp.conj(c)


def _lr_matrix(m, d):
    # m = (L+R)/2 (real-valued mono path), d = (L-R)/2 analytic mix.
    mono = jnp.real(m)
    diff = jnp.real(d)
    return jax.lax.complex(mono + diff, mono - diff)


def _add_stereo_decode(g: Graph, mpx: NodeRef, separation: float,
                       volume: float, use_bank: bool = True,
                       ir_len=None):
    """Add the MPX stereo decode nodes; returns (stereo, pilot) node refs.

    ``mpx`` must be the real-valued composite baseband at 384 kHz.  The
    returned ``stereo`` node is ``L + jR`` at 48 kHz after deemphasis;
    ``pilot`` is the analytic 19 kHz pilot at MPX rate (its level gates
    stereo/mono blending in a real receiver).
    """
    # One FilterBank: the three analysis bands share a single forward FFT
    # and one previous-chunk state (per-band outputs are identical to
    # standalone Filter blocks — shared-transform linearity).  The
    # separate-filters form is kept as an equivalence/benchmark reference
    # (use_bank=False).
    if use_bank:
        mono, pilot, sub = g.bank(
            FilterBank([_mono_band, _pilot_band, _subcarrier_band],
                       ir_len=ir_len), mpx)
    else:
        mono = g.add(Filter.new(_mono_band, ir_len=ir_len), mpx)
        pilot = g.add(Filter.new(_pilot_band, ir_len=ir_len), mpx)
        sub = g.add(Filter.new(_subcarrier_band, ir_len=ir_len), mpx)
    carrier = g.add(MapSample(_double_phase), pilot)
    diff = g.add(Combine(_mix_subcarrier), (sub, carrier))
    # Tunable stereo separation (1 = full stereo, 0 = mono on both ears):
    # a live-settable gain on the difference path.
    diff = g.add(GainControl(separation), diff)
    stereo = g.add(Combine(_lr_matrix), (mono, diff))
    stereo = g.chain([
        Filter.new_rectangular(_deemphasis_band, ir_len=ir_len),
        Downsampler(WFM_AUDIO_RATE, 2.0 * 20000.0),
        GainControl(volume),
    ], stereo)
    return stereo, pilot


def stereo_mpx_decoder(separation: float = 1.0,
                       volume: float = 1.0,
                       use_bank: bool = True,
                       filter_ir_len=None) -> Graph:
    """Standalone MPX decoder: input "mpx" (real composite at 384 kHz) ->
    outputs "stereo" (L + jR at 48 kHz) and "pilot" (analytic pilot)."""
    g = Graph()
    mpx = g.input("mpx")
    stereo, pilot = _add_stereo_decode(g, mpx, separation, volume, use_bank,
                                       ir_len=filter_ir_len)
    g.output("stereo", stereo)
    g.output("pilot", pilot)
    return g


def wfm_stereo_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                        deviation: float = 150000.0,
                        separation: float = 1.0,
                        filter_ir_len=None) -> Graph:
    """Full stereo WFM receiver as one compiled DAG.

    IQ 1.024 Msps [batch, 16384] -> tune -> decimate 384 kHz -> +-100 kHz
    channel filter -> FM demod (the composite MPX) -> stereo decode.
    Outputs "stereo" (L + jR at 48 kHz) and "pilot".  The front end and
    demodulator are exactly the mono receiver's blocks
    (``models/wfm.py::wfm_receiver``); only the post-demod audio path
    differs.  Every node time-shards (the MPX decode subgraph:
    tests/test_stereo.py::test_stereo_graph_time_shards and
    __graft_entry__ dryrun case 7; the front-end blocks: the WFM cases in
    tests/test_parallel.py).
    """
    g = Graph()
    iq = g.input("iq")
    mpx = g.chain([FreqShifter.with_shift(tune_shift),
                   Downsampler(MPX_RATE, 200000.0), Filter.new(_lowpass_100k,
                                     ir_len=filter_ir_len),
                   FmDemod(deviation)], iq)
    stereo, pilot = _add_stereo_decode(g, mpx, separation, volume,
                                       ir_len=filter_ir_len)
    g.output("stereo", stereo)
    g.output("pilot", pilot)
    return g
