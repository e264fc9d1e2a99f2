"""The outbound peer-wire half of the BitTorrent engine.

So far the port carries only what the verification path needs: the
request block size and the protocol error a failed piece raises. The
``PeerConnection`` state machine comes with the BitTorrent slice.
"""

from __future__ import annotations

from .http import TransferError

BLOCK_SIZE = 16 * 1024


class PeerProtocolError(TransferError):
    pass
