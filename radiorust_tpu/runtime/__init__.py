"""Dynamic streaming runtime.

The compiled-graph path (``blocks/base.py``) is the device execution
model: static chains fused by XLA.  This package provides the reference's
*dynamic* dataflow on top of it — live (re)connectable producer/consumer
blocks exchanging Signal messages over capacity-1 broadcast channels with
backpressure (``src/flow.rs``, ``src/sync/broadcast_bp.rs``) — so
applications that need runtime rewiring, elastic buffering, or hardware I/O
keep the reference's semantics while every chunk's math still runs on
device through the same bound blocks.
"""

from .flow import (Receiver, ReceiverConnector, Sender, SenderConnector,
                   new_receiver, new_sender)
from .blocks import (Blackhole, Buffer, FileSink, ArraySink, ArraySource,
                     KeyerSource, MapSignal, Rechunker, RuntimeBlock,
                     RuntimeGraph, Silence, wait_until)
from .recycle import serve_recycling
