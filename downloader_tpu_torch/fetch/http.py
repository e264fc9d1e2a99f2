"""HTTP/HTTPS download backend.

So far the port carries only the error type the verification path
raises; the backend itself comes with the one-job slice.
"""

from __future__ import annotations


class TransferError(Exception):
    """A download failed (HTTP error status, short read, or network error)."""
