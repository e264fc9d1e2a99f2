"""The pipeline job contract: ``Media``, ``Download``, ``Convert``.

Mirrors the reference's use of the external ``tritonmedia.go`` protobuf
types (SURVEY.md §2 row 8):

- ``api.Download{Media:{Id, SourceURI}}`` consumed from the ``v1.download``
  queue (cmd/downloader/downloader.go:105-116),
- ``api.Convert{CreatedAt, Media}`` produced onto ``v1.convert``
  (cmd/downloader/downloader.go:136-147).

The upstream .proto is not vendored in the reference, so field numbers here
are this repo's own (documented in proto/tritonmedia.proto); both ends of
this rebuild's pipeline share this module, so the contract is internally
consistent. Unknown fields are skipped on decode and therefore tolerated,
matching protobuf forward-compatibility semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import protowire as wire


@dataclass
class Media:
    """proto: message Media { string id = 1; string source_uri = 2; }"""

    id: str = ""
    source_uri: str = ""

    def marshal(self) -> bytes:
        return wire.encode_string(1, self.id) + wire.encode_string(2, self.source_uri)

    @classmethod
    def unmarshal(cls, buf: bytes) -> "Media":
        msg = cls()
        for num, wt, value in wire.iter_fields(buf):
            if num == 1:
                msg.id = wire.expect_string(wt, value)
            elif num == 2:
                msg.source_uri = wire.expect_string(wt, value)
        return msg


@dataclass
class Download:
    """proto: message Download { Media media = 1; }

    ``media`` is None when absent on the wire, mirroring proto submessage
    presence (the Go type is a nillable pointer); consumers must treat a
    missing media block as a malformed job, where the reference would
    nil-panic (cmd/downloader/downloader.go:116).
    """

    media: Media | None = None

    def marshal(self) -> bytes:
        return wire.encode_submessage(
            1, None if self.media is None else self.media.marshal()
        )

    @classmethod
    def unmarshal(cls, buf: bytes) -> "Download":
        msg = cls()
        for num, wt, value in wire.iter_fields(buf):
            if num == 1:
                msg.media = Media.unmarshal(wire.expect_len(wt, value))
        return msg


@dataclass
class Convert:
    """proto: message Convert { string created_at = 1; Media media = 2; }"""

    created_at: str = ""
    media: Media | None = None

    def marshal(self) -> bytes:
        return wire.encode_string(1, self.created_at) + wire.encode_submessage(
            2, None if self.media is None else self.media.marshal()
        )

    @classmethod
    def unmarshal(cls, buf: bytes) -> "Convert":
        msg = cls()
        for num, wt, value in wire.iter_fields(buf):
            if num == 1:
                msg.created_at = wire.expect_string(wt, value)
            elif num == 2:
                msg.media = Media.unmarshal(wire.expect_len(wt, value))
        return msg
