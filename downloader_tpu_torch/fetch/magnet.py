"""Magnet URI (BEP 9 / BEP 53) and .torrent metainfo parsing.

The reference accepts only magnet links at runtime (torrent.go:57-64 —
``.torrent`` files are registered but rejected, a stubbed path this rebuild
actually implements). This module parses both job flavors into one
``TorrentJob`` the backend consumes.
"""

from __future__ import annotations

import hashlib
import urllib.parse
from dataclasses import dataclass, field

from . import bencode


class MagnetError(ValueError):
    pass


def parse_hostport(text: str) -> tuple[str, int] | None:
    """``host:port`` / ``[v6]:port`` → (host, port); None if malformed
    or the port is outside 1-65535 (sendto would raise OverflowError,
    which is not an OSError and so would escape the callers' nets).
    A bare IPv6 address without brackets is rejected rather than
    misparsed into (address-prefix, last-group) garbage."""
    host, sep, port = text.strip().rpartition(":")
    # isascii() too: Unicode digits (e.g. '²') pass isdigit() but make
    # int() raise, which would escape as ValueError instead of None
    if not sep or not host or not port.isdigit() or not port.isascii():
        return None
    if not 0 < int(port) < 65536:
        return None
    if ":" in host:  # IPv6 must be bracketed to be distinguishable
        if not (host.startswith("[") and host.endswith("]")) or len(host) < 3:
            return None
        host = host[1:-1]
    return (host, int(port))


@dataclass
class TorrentJob:
    info_hash: bytes  # 20-byte SHA-1 of the bencoded info dict
    display_name: str = ""
    trackers: tuple[str, ...] = ()
    # BEP 12 announce-list tiers: trackers grouped by priority. Magnets
    # have no tier syntax, so each tr= is its own tier (anacrolix does
    # the same); .torrent files carry the real structure. Empty when
    # there are no trackers; always covers every entry of ``trackers``.
    tracker_tiers: tuple[tuple[str, ...], ...] = ()
    # explicit peer addresses from the magnet's x.pe params (BEP 9)
    peer_hints: tuple[tuple[str, int], ...] = ()
    # BEP 19 webseeds: HTTP(S)/FTP sources for the content itself, from the
    # metainfo's url-list or the magnet's ws= params
    web_seeds: tuple[str, ...] = ()
    # populated when parsed from a .torrent file (magnet jobs fetch it
    # from peers via BEP 9 metadata exchange)
    info: dict | None = field(default=None, repr=False)


def parse_magnet(uri: str) -> TorrentJob:
    parsed = urllib.parse.urlparse(uri)
    if parsed.scheme != "magnet":
        raise MagnetError(f"not a magnet URI: scheme '{parsed.scheme}'")
    params = urllib.parse.parse_qs(parsed.query)

    info_hash = b""
    for xt in params.get("xt", []):
        if xt.startswith("urn:btih:"):
            raw = xt[len("urn:btih:") :]
            if len(raw) == 40:
                try:
                    info_hash = bytes.fromhex(raw)
                except ValueError as exc:
                    raise MagnetError(f"invalid hex info-hash: {raw!r}") from exc
            elif len(raw) == 32:
                import base64

                try:
                    info_hash = base64.b32decode(raw.upper())
                except Exception as exc:
                    raise MagnetError(f"invalid base32 info-hash: {raw!r}") from exc
            else:
                raise MagnetError(f"info-hash must be 40 hex or 32 base32 chars: {raw!r}")
            break
    if not info_hash:
        raise MagnetError("magnet URI has no urn:btih exact topic")

    peer_hints = [
        parsed_hint
        for parsed_hint in map(parse_hostport, params.get("x.pe", []))
        if parsed_hint is not None
    ]

    web_seeds = [
        url
        for url in params.get("ws", [])
        if url.startswith(("http://", "https://", "ftp://"))
    ]

    trackers = tuple(params.get("tr", []))
    return TorrentJob(
        info_hash=info_hash,
        display_name=params.get("dn", [""])[0],
        trackers=trackers,
        tracker_tiers=tuple((t,) for t in trackers),
        peer_hints=tuple(peer_hints),
        web_seeds=tuple(web_seeds),
    )


def _raw_info_span(data: bytes) -> bytes:
    """Return the exact byte span of the top-level ``info`` value. The
    info-hash must be computed over the bytes as they appear in the file —
    re-encoding would silently canonicalize (e.g. re-sort missorted dict
    keys) and produce a hash no peer or tracker recognizes."""
    if not data.startswith(b"d"):
        raise MagnetError(".torrent file is not a bencoded dict")
    pos = 1
    while pos < len(data) and data[pos : pos + 1] != b"e":
        key, pos = bencode._decode(data, pos)
        start = pos
        _, pos = bencode._decode(data, pos)
        if key == b"info":
            return data[start:pos]
    raise MagnetError(".torrent file has no info dict")


def parse_metainfo(data: bytes) -> TorrentJob:
    """Parse a .torrent file; the info-hash is the SHA-1 of the bencoded
    info dict exactly as it appeared in the file (BEP 3)."""
    try:
        meta = bencode.decode(data)
        raw_info = _raw_info_span(data)
    except bencode.BencodeError as exc:
        raise MagnetError(f"invalid .torrent file: {exc}") from exc
    if not isinstance(meta, dict) or b"info" not in meta:
        raise MagnetError(".torrent file has no info dict")
    info = meta[b"info"]
    if not isinstance(info, dict):
        raise MagnetError(".torrent info is not a dict")

    info_hash = hashlib.sha1(raw_info).digest()

    trackers: list[str] = []
    tiers: list[tuple[str, ...]] = []
    announce = meta.get(b"announce")
    if isinstance(announce, bytes):
        trackers.append(announce.decode("utf-8", "replace"))
    for tier in meta.get(b"announce-list", []) or []:
        if isinstance(tier, list):
            tier_urls: list[str] = []
            for tracker in tier:
                if isinstance(tracker, bytes):
                    url = tracker.decode("utf-8", "replace")
                    if url not in tier_urls:
                        tier_urls.append(url)
                    if url not in trackers:
                        trackers.append(url)
            if tier_urls:
                tiers.append(tuple(tier_urls))
    if not tiers and trackers:
        # no (usable) announce-list: the bare announce is tier 0
        # (BEP 12: clients ignore announce when announce-list exists)
        tiers = [tuple(trackers)]
    elif tiers and trackers and trackers[0] not in {
        url for tier_urls in tiers for url in tier_urls
    }:
        # bare announce not repeated in announce-list: keep it as a
        # last-resort tier so it is never silently dropped
        tiers.append((trackers[0],))

    web_seeds: list[str] = []
    url_list = meta.get(b"url-list")
    if isinstance(url_list, bytes):  # BEP 19 allows a bare string
        url_list = [url_list]
    if not isinstance(url_list, list):
        url_list = []  # hostile metainfo: url-list of a non-list type
    for entry in url_list:
        if isinstance(entry, bytes):
            url = entry.decode("utf-8", "replace")
            if (
                url.startswith(("http://", "https://", "ftp://"))
                and url not in web_seeds
            ):
                web_seeds.append(url)

    name = info.get(b"name", b"")
    return TorrentJob(
        info_hash=info_hash,
        display_name=name.decode("utf-8", "replace") if isinstance(name, bytes) else "",
        trackers=tuple(trackers),
        tracker_tiers=tuple(tiers),
        web_seeds=tuple(web_seeds),
        info=info,
    )
