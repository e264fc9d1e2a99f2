"""BitTorrent download backend.

Rebuild of the reference's ``internal/downloader/torrent`` package
(torrent.go:18-119), which delegates to anacrolix/torrent. Registration
matches the reference exactly: protocol ``magnet`` plus file extension
``.torrent`` (torrent.go:26-37) — and unlike the reference, which registers
``.torrent`` but then rejects any non-magnet scheme at runtime
(torrent.go:62-64), this backend accepts both job flavors: a magnet URI, or
an http(s) URL to a .torrent file which is fetched and parsed.

Per-job isolation mirrors the reference's fresh-client-per-job design
("prevent state leakage", torrent.go:43-44): every download builds its own
session state; nothing persists between jobs.

The metadata timeout matches the reference's 10 minutes (torrent.go:67-76)
and, unlike the reference — whose WaitAll ignores ctx cancellation
(torrent.go:104-106, its own TODO) — cancellation here aborts the transfer
promptly at every stage.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.parse
import urllib.request

from ..utils import get_logger
from ..utils.cancel import CancelToken
from .dispatch import BackendRegistration, ProgressFn
from .http import TransferError
from .magnet import MagnetError, TorrentJob, parse_magnet, parse_metainfo

log = get_logger("fetch.torrent")

METADATA_TIMEOUT = 600.0  # reference torrent.go:67: 10 minutes


class TorrentBackend:
    # job mirrors (X-Mirrors / MIRROR_URLS) ride as extra BEP 19
    # webseeds: the swarm races them against peers piece for piece
    supports_mirrors = True

    def __init__(
        self,
        progress_interval: float = 1.0,
        metadata_timeout: float = METADATA_TIMEOUT,
        dht_bootstrap: tuple[tuple[str, int], ...] | None = None,
        encryption: str = "allow",
        transport: str = "both",
        lsd: bool = False,
        announce_all: bool = False,
        shared_dht: bool = False,
        dht_state_path: str | None = None,
    ):
        self._progress_interval = progress_interval
        self._metadata_timeout = metadata_timeout
        # None = BEP 5 defaults; () disables DHT (hermetic tests)
        self._dht_bootstrap = dht_bootstrap
        # MSE policy: off | allow | prefer | require (peer.py
        # ENCRYPTION_MODES) — anacrolix speaks MSE by default too
        self._encryption = encryption
        # outbound transport policy: tcp | utp | both (peer.py
        # TRANSPORT_MODES) — anacrolix dials both by default too
        self._transport = transport
        # BEP 14 LAN multicast discovery (exceeds the reference).
        # Library default OFF — real multicast from library consumers
        # and tests would cross-talk on the shared well-known group;
        # the daemon/CLI enables it via the LSD env flag (default on)
        self._lsd = lsd
        # BEP 12: tier-ordered announce by default; True announces to
        # every tracker concurrently (CLI: TRACKER_ANNOUNCE=all)
        self._announce_all = announce_all
        # shared_dht=True: ONE process-lifetime DHT node for every job
        # this backend runs (the daemon's posture — anacrolix keeps its
        # DHT server alive for the process; the reference's per-job
        # client is torrent.go:43-44). Created lazily on first use;
        # close() persists its routing table when dht_state_path is
        # set. False = each job builds and tears down its own node
        # (one-shot CLI / hermetic tests).
        self._shared_dht = shared_dht
        self._dht_state_path = dht_state_path
        self._dht_node = None
        self._dht_lock = threading.Lock()

    def _shared_node(self):
        """The lazily-created process-lifetime DHT node, or None when
        sharing is off or DHT is disabled. Creation failures are
        logged and retried on the next job (a transient bind failure
        must not permanently disable DHT for the process)."""
        if not self._shared_dht or self._dht_bootstrap == ():
            return None
        with self._dht_lock:
            if self._dht_node is None:
                from .dht import DEFAULT_BOOTSTRAP, DHTNode

                try:
                    self._dht_node = DHTNode(
                        bootstrap=self._dht_bootstrap or DEFAULT_BOOTSTRAP,
                        state_path=self._dht_state_path,
                    )
                except OSError as exc:
                    log.with_fields(error=str(exc)).info(
                        "shared dht node unavailable"
                    )
                    return None
            return self._dht_node

    def close(self) -> None:
        """Release process-lifetime resources (the shared DHT node,
        which persists its routing table when configured)."""
        with self._dht_lock:
            node, self._dht_node = self._dht_node, None
        if node is not None:
            node.close()

    def register(self) -> BackendRegistration:
        return BackendRegistration(
            name="torrent",
            protocols=("magnet",),
            file_extensions=(".torrent",),
        )

    # -- job parsing -----------------------------------------------------

    def _job_from_url(self, token: CancelToken, url: str) -> TorrentJob:
        scheme = urllib.parse.urlparse(url).scheme
        if scheme == "magnet":
            return parse_magnet(url)
        if scheme in ("http", "https"):
            # the .torrent-file path the reference stubs out (torrent.go:62-64)
            log.with_fields(url=url).info("fetching .torrent metainfo file")
            try:
                response = urllib.request.urlopen(url, timeout=30)
            except (urllib.error.URLError, OSError) as exc:
                raise TransferError(f"failed to fetch .torrent file: {exc}") from exc
            remove_hook = token.add_callback(response.close)
            try:
                with response:
                    data = response.read()
            except (urllib.error.URLError, OSError) as exc:
                token.raise_if_cancelled()
                raise TransferError(f"failed to fetch .torrent file: {exc}") from exc
            finally:
                remove_hook()
            return parse_metainfo(data)
        raise TransferError(f"unsupported scheme '{scheme}'")

    # -- download --------------------------------------------------------

    def download(
        self,
        token: CancelToken,
        base_dir: str,
        progress: ProgressFn,
        url: str,
        mirrors: "tuple[str, ...]" = (),
    ) -> None:
        try:
            job = self._job_from_url(token, url)
        except MagnetError as exc:
            raise TransferError(str(exc)) from exc
        if mirrors:
            # a torrent job's mirrors ARE webseeds: HTTP(S)/FTP origins
            # serving the same content ride the swarm's claim pool and
            # race the peers piece for piece (BEP 19), with the shared
            # source board accounting their rates and demotions
            merged = tuple(
                dict.fromkeys((*job.web_seeds, *mirrors))
            )
            if merged != job.web_seeds:
                log.with_fields(extra=len(merged) - len(job.web_seeds)).info(
                    "riding job mirrors as extra webseeds"
                )
                job.web_seeds = merged

        log.with_fields(
            info_hash=job.info_hash.hex(), name=job.display_name
        ).info("prepared torrent job")

        from .peer import SwarmDownloader  # deferred: heaviest module

        downloader = SwarmDownloader(
            job,
            base_dir,
            metadata_timeout=self._metadata_timeout,
            progress_interval=self._progress_interval,
            dht_bootstrap=self._dht_bootstrap,
            encryption=self._encryption,
            transport=self._transport,
            lsd=self._lsd,
            announce_all=self._announce_all,
            dht_node=self._shared_node(),
        )
        downloader.run(token, lambda percent: progress(url, percent))
        progress(url, 100.0)
