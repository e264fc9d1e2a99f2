"""Minimal S3-compatible client: bucket ensure + streamed object PUT.

The reference wraps minio-go v6 (uploader.go:41-56); this client speaks the
S3 REST API directly over http.client with SigV4 auth (sigv4.py) or
anonymous requests. Path-style addressing is used so it works against
MinIO, an in-process stub, or AWS alike (the reference uses
BucketLookupAuto, uploader.go:50).

Operations implemented are exactly the reference's usage surface:
``bucket_exists`` + ``make_bucket`` (uploader.go:64-70) and ``put_object``
streaming from a file (uploader.go:86-89) — including the behavior
minio-go gives the reference for free: objects above 64 MiB go through
the multipart API (initiate / upload-part / complete, abort on failure),
since a single PUT tops out at 5 GiB on real S3 and media files don't.
"""

from __future__ import annotations

import contextlib
import hashlib
import http.client
import io
import os
import re
import stat
import tempfile
import threading
import time
import urllib.parse
from typing import BinaryIO, Mapping

from ..utils import get_logger, tracing, zero_copy_from_env
from ..utils.cancel import CancelToken
from ..utils.failpoints import FAILPOINTS
from ..utils.netio import SocketWaiter
from . import sigv4
from .credentials import Credentials

log = get_logger("store.s3")

_STREAM_CHUNK = 1024 * 1024
_SENDFILE_WINDOW = 4 * 1024 * 1024

# multipart sizing mirrors minio-go v6's optimalPartInfo: single PUT up
# to 64 MiB, then parts of max(64 MiB, ceil(size/10000)) so any object
# fits in S3's 10,000-part limit
MULTIPART_THRESHOLD = 64 * 1024 * 1024
_MAX_PARTS = 10_000
_UPLOAD_ID_RE = re.compile(rb"<UploadId>([^<]+)</UploadId>")
_UPLOAD_ENTRY_RE = re.compile(
    rb"<Upload>.*?<Key>([^<]*)</Key>.*?<UploadId>([^<]+)</UploadId>.*?"
    rb"</Upload>",
    re.S,
)


def multipart_threshold_from_env(environ=None) -> int:
    """``S3_MULTIPART_THRESHOLD``: bytes above which objects take the
    multipart API (and below which the streaming pipeline declines).
    Operators with small median objects (or chaos suites that must
    exercise multipart without 64 MiB transfers) lower it; the floor
    of 5 MiB matches real S3's minimum part size."""
    env = os.environ if environ is None else environ
    raw = (env.get("S3_MULTIPART_THRESHOLD") or "").strip()
    if not raw:
        return MULTIPART_THRESHOLD
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid S3_MULTIPART_THRESHOLD (want bytes)"
        )
        return MULTIPART_THRESHOLD


def part_size_from_env(environ=None) -> "int | None":
    """``S3_PART_SIZE``: fixed multipart part size in bytes (empty =
    derive per object, minio-go optimalPartInfo semantics)."""
    env = os.environ if environ is None else environ
    raw = (env.get("S3_PART_SIZE") or "").strip()
    if not raw:
        return None
    try:
        return max(1, int(raw))
    except ValueError:
        log.with_fields(value=raw).warning(
            "ignoring invalid S3_PART_SIZE (want bytes)"
        )
        return None


def _fileno_of(body) -> int | None:
    """The descriptor behind ``body`` if it is a REGULAR os-level file on
    a platform with os.sendfile, else None (BytesIO, pipes, sockets, and
    sendfile-less platforms take the copy loop — pipes would crash at
    tell(), and sendfile wants mmap-able input)."""
    if not hasattr(os, "sendfile"):
        return None
    fileno = getattr(body, "fileno", None)
    if fileno is None:
        return None
    try:
        fd = fileno()
        if not stat.S_ISREG(os.fstat(fd).st_mode):
            return None
        return fd
    except (OSError, ValueError, io.UnsupportedOperation):
        return None


def _seekable(stream) -> bool:
    """IOBase.seekable when available; SpooledTemporaryFile (pre-3.11)
    supports seek/tell without implementing the IOBase probe."""
    probe = getattr(stream, "seekable", None)
    if probe is not None:
        return probe()
    return hasattr(stream, "seek")


class S3Error(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"s3: {status} {message}")
        self.status = status


class S3Client:
    def __init__(
        self,
        endpoint: str,
        credentials: Credentials,
        secure: bool = False,
        region: str = "us-east-1",
        timeout: float = 60.0,
        zero_copy: bool = True,
        multipart_threshold: int = MULTIPART_THRESHOLD,
        part_size: int | None = None,
    ):
        self._host = endpoint
        self._credentials = credentials
        self._secure = secure
        self._region = region
        self._timeout = timeout
        # operator escape hatch (ZEROCOPY=off); the bench's baseline
        # uses it to emulate the reference's userspace upload path
        self._zero_copy = zero_copy
        self._multipart_threshold = multipart_threshold
        self._part_size = part_size  # None = derive per object
        # per-thread keep-alive scope (connection_scope): while active,
        # requests issued by THAT thread reuse one connection instead
        # of paying a TCP (+TLS) handshake per call — the store half of
        # the batched small-object fast path. Thread-local so batch
        # workers can't share (and corrupt) one socket.
        self._reuse = threading.local()

    @property
    def multipart_threshold(self) -> int:
        """Objects at or above this size take the multipart API; the
        streaming pipeline uses it as its eligibility floor."""
        return self._multipart_threshold

    def part_size_for(self, size: int) -> int:
        """The part size this client would use for an object of
        ``size`` bytes (minio-go optimalPartInfo semantics) — public so
        the streaming pipeline plans part boundaries identically."""
        return self._derived_part_size(size)

    @classmethod
    def from_endpoint_url(
        cls,
        url: str,
        credentials: Credentials,
        region: str = "us-east-1",
        zero_copy: bool | None = None,
    ) -> "S3Client":
        """Build from an S3_ENDPOINT-style URL; https selects TLS, and the
        host:port is extracted, as in the reference (uploader.go:26-41)."""
        parsed = urllib.parse.urlparse(url)
        host = parsed.hostname or ""
        if parsed.port:
            host = f"{host}:{parsed.port}"
        if not host:
            raise ValueError(f"invalid S3 endpoint URL: {url!r}")
        if zero_copy is None:
            zero_copy = zero_copy_from_env()
        return cls(
            host,
            credentials,
            secure=parsed.scheme == "https",
            region=region,
            zero_copy=zero_copy,
            multipart_threshold=multipart_threshold_from_env(),
            part_size=part_size_from_env(),
        )

    # -- request plumbing ------------------------------------------------

    def _connect(self, timeout: float | None = None) -> http.client.HTTPConnection:
        conn_cls = (
            http.client.HTTPSConnection if self._secure else http.client.HTTPConnection
        )
        return conn_cls(
            self._host, timeout=self._timeout if timeout is None else timeout
        )

    @contextlib.contextmanager
    def connection_scope(self):
        """Reuse ONE connection for every request the calling thread
        issues inside the scope (kept alive between calls, closed on
        exit). The batched fast path wraps a whole batch of single-PUT
        uploads in one scope, so N small objects cost one handshake
        instead of N. A parked connection the server closed while idle
        is retried once on a fresh one — the caller never sees it.
        Nesting is a no-op; other threads are unaffected."""
        if getattr(self._reuse, "active", False):
            yield
            return
        self._reuse.active = True
        self._reuse.conn = None
        try:
            yield
        finally:
            conn = getattr(self._reuse, "conn", None)
            self._reuse.active = False
            self._reuse.conn = None
            if conn is not None:
                conn.close()

    def _checkout_connection(
        self, timeout: float | None
    ) -> tuple[http.client.HTTPConnection, bool]:
        """(connection, reused): the thread's parked scope connection
        when available, else a fresh connected one. Explicit timeout
        overrides (abort's short deadline) always get a fresh
        connection — a parked socket carries the default timeout."""
        if timeout is None and getattr(self._reuse, "active", False):
            conn = getattr(self._reuse, "conn", None)
            if conn is not None:
                self._reuse.conn = None  # checked out; re-parked on success
                return conn, True
        conn = self._connect(timeout)
        conn.connect()
        # a cancellation callback closes the socket mid-request;
        # http.client would silently REOPEN it on the next send and
        # desync the exchange — make the close terminal instead
        conn.auto_open = 0
        return conn, False

    def _park_connection(self, conn: http.client.HTTPConnection, keepalive: bool) -> None:
        if keepalive and getattr(self._reuse, "active", False):
            self._reuse.conn = conn
        else:
            conn.close()

    def _request(
        self,
        method: str,
        path: str,
        body: BinaryIO | None = None,
        content_length: int = 0,
        payload_hash: str = sigv4.EMPTY_SHA256,
        content_type: str | None = None,
        token: CancelToken | None = None,
        query: Mapping[str, str] | None = None,
        timeout: float | None = None,
    ) -> tuple[int, bytes, dict[str, str]]:
        query = dict(query or {})
        headers: dict[str, str] = {"Host": self._host}
        if content_type:
            headers["Content-Type"] = content_type
        if body is not None:
            headers["Content-Length"] = str(content_length)

        if not self._credentials.anonymous:
            amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            headers["x-amz-date"] = amz_date
            headers["x-amz-content-sha256"] = payload_hash
            if self._credentials.session_token:
                headers["x-amz-security-token"] = self._credentials.session_token
            headers["Authorization"] = sigv4.sign(
                method,
                path,
                query,
                headers,
                payload_hash,
                self._credentials.access_key,
                self._credentials.secret_key,
                self._region,
                "s3",
                amz_date,
            )

        # sign with the raw path (SigV4 canonicalization encodes it once);
        # percent-encode only for the request line. The query string on
        # the wire must byte-match the signed canonical query, so encode
        # it the same way sigv4.canonical_request does (sorted, quote
        # with the RFC 3986 unreserved set — urlencode's '+' for space
        # would break the signature)
        encoded_path = urllib.parse.quote(path, safe="/-._~")
        if query:
            encoded_path += "?" + "&".join(
                f"{urllib.parse.quote(k, safe='-._~')}"
                f"={urllib.parse.quote(v, safe='-._~')}"
                for k, v in sorted(query.items())
            )
        # rewind point for the stale-keep-alive retry: a parked scope
        # connection the server closed shows up as a send/read failure
        # on the FIRST exchange after reuse, and the retry must replay
        # the body from where this call found it
        body_start = (
            body.tell() if body is not None and _seekable(body) else None
        )
        while True:
            conn, reused = self._checkout_connection(timeout)
            remove_hook = (
                token.add_callback(conn.close)
                if token is not None
                else lambda: None
            )
            try:
                conn.putrequest(
                    method, encoded_path, skip_host=True, skip_accept_encoding=True
                )
                for name, value in headers.items():
                    conn.putheader(name, value)
                conn.endheaders()
                if body is not None:
                    self._send_body(conn, body, content_length, token)
                response = conn.getresponse()
                response_headers = {
                    k.lower(): v for k, v in response.getheaders()
                }
                payload = response.read()
            except (OSError, http.client.HTTPException):
                conn.close()
                if token is not None:
                    # the failure may BE the cancellation (closed-under-us
                    # socket); report it as such, not as a transport error
                    token.raise_if_cancelled()
                if reused and (body is None or body_start is not None):
                    # stale pool entry, not a request verdict: replay
                    # once on a fresh connection
                    if body_start is not None:
                        body.seek(body_start)
                    continue
                raise
            finally:
                remove_hook()
            self._park_connection(conn, keepalive=not response.will_close)
            return response.status, payload, response_headers

    def _send_body(
        self,
        conn: http.client.HTTPConnection,
        body: BinaryIO,
        content_length: int,
        token: CancelToken | None,
    ) -> None:
        """Stream the request body. Plain-socket PUTs of real files go
        zero-copy via os.sendfile in bounded windows (so cancellation
        still gets a look-in), never past the declared Content-Length;
        TLS and non-file bodies fall back to a chunked userspace loop."""
        sock = getattr(conn, "sock", None)
        in_fd = (
            _fileno_of(body)
            if self._zero_copy and not self._secure and sock is not None
            else None
        )
        if in_fd is not None:
            offset = body.tell()
            remaining = content_length
            with SocketWaiter(sock, write=True, what="write") as waiter:
                while remaining > 0:
                    if token is not None:
                        token.raise_if_cancelled()
                    window = min(_SENDFILE_WINDOW, remaining)
                    try:
                        sent = os.sendfile(sock.fileno(), in_fd, offset, window)
                    except BlockingIOError:
                        # socket has a timeout => non-blocking; wait until
                        # the send buffer drains, honoring the timeout
                        waiter.wait(self._timeout)
                        continue
                    if sent == 0:
                        break  # EOF before Content-Length: short body
                    offset += sent
                    remaining -= sent
            body.seek(offset)
            return
        remaining = content_length
        while remaining > 0:
            if token is not None:
                token.raise_if_cancelled()
            # bound by Content-Length, not EOF: a multipart part's body is
            # a window of a larger file, and reading to EOF would stream
            # the rest of the file into one part
            chunk = body.read(min(_STREAM_CHUNK, remaining))
            if not chunk:
                break
            conn.send(chunk)
            remaining -= len(chunk)

    @staticmethod
    def _object_path(bucket: str, key: str) -> str:
        return f"/{bucket}/{key}"

    # -- API surface -----------------------------------------------------

    def bucket_exists(self, bucket: str) -> bool:
        status, _, _ = self._request("HEAD", f"/{bucket}")
        if status in (200,):
            return True
        if status in (404,):
            return False
        raise S3Error(status, f"HEAD bucket {bucket}")

    def make_bucket(self, bucket: str) -> None:
        status, body, _ = self._request("PUT", f"/{bucket}")
        if status not in (200, 204):
            raise S3Error(status, body.decode(errors="replace")[:200])

    def get_object(
        self, bucket: str, key: str, token: CancelToken | None = None
    ) -> bytes:
        """Whole-object GET — the canary plane's outside-in read-back
        lane (utils/canary.py verifies uploaded probe objects
        byte-for-byte). Buffers in memory: callers control size, and
        probe objects are small by construction."""
        status, payload, _ = self._request(
            "GET", self._object_path(bucket, key), token=token
        )
        if status != 200:
            raise S3Error(status, f"GET object {bucket}/{key}")
        return payload

    def put_object(
        self,
        bucket: str,
        key: str,
        stream: BinaryIO,
        size: int,
        content_type: str = "application/octet-stream",
        token: CancelToken | None = None,
        sign_payload: bool = False,
    ) -> None:
        """Streamed PUT, single pass over the data by default (signed as
        UNSIGNED-PAYLOAD, still SigV4-authenticated). ``sign_payload=True``
        opts into a signed content hash at the cost of reading seekable
        streams twice — avoid for large media files.

        Objects larger than the multipart threshold take the multipart
        API instead, exactly as minio-go does for the reference
        (uploader.go:86-89 via PutObjectWithContext →
        putObjectMultipartStream above 64 MiB); ``sign_payload`` is
        honored there per part. Non-seekable bodies above the threshold
        are spooled to a temp file first — a 5+ GiB pipe must not fall
        back to a single PUT that real S3 rejects, and spooling keeps
        the retry-per-part and abort-on-failure semantics."""
        if size > self._multipart_threshold:
            if _seekable(stream):
                self._put_multipart(
                    bucket, key, stream, size, content_type, token, sign_payload
                )
                return
            with tempfile.SpooledTemporaryFile(
                max_size=min(self._multipart_threshold, 16 * 1024 * 1024)
            ) as spool:
                remaining = size
                while remaining > 0:
                    if token is not None:
                        token.raise_if_cancelled()
                    chunk = stream.read(min(_STREAM_CHUNK, remaining))
                    if not chunk:
                        raise S3Error(
                            0,
                            f"short body: got {size - remaining} of {size} "
                            "bytes from non-seekable stream",
                        )
                    spool.write(chunk)
                    remaining -= len(chunk)
                spool.seek(0)
                self._put_multipart(
                    bucket, key, spool, size, content_type, token, sign_payload
                )
            return
        payload_hash = "UNSIGNED-PAYLOAD"
        if self._credentials.anonymous:
            payload_hash = sigv4.EMPTY_SHA256  # unused when unsigned
        elif sign_payload and stream.seekable():
            digest = hashlib.sha256()
            start = stream.tell()
            while True:
                chunk = stream.read(_STREAM_CHUNK)
                if not chunk:
                    break
                digest.update(chunk)
            stream.seek(start)
            payload_hash = digest.hexdigest()

        status, body, _ = self._request(
            "PUT",
            self._object_path(bucket, key),
            body=stream,
            content_length=size,
            payload_hash=payload_hash,
            content_type=content_type,
            token=token,
        )
        if status not in (200, 201, 204):
            raise S3Error(status, body.decode(errors="replace")[:200])

    def put_bytes(self, bucket: str, key: str, data: bytes, **kwargs) -> None:
        self.put_object(bucket, key, io.BytesIO(data), len(data), **kwargs)

    # -- multipart upload ------------------------------------------------

    def _derived_part_size(self, size: int) -> int:
        if self._part_size is not None:
            return self._part_size
        # ceil(size / 10000), rounded up to a MiB, floored at the single-
        # PUT threshold — minio-go v6 optimalPartInfo semantics
        by_count = -(-size // _MAX_PARTS)
        by_count = -(-by_count // (1024 * 1024)) * (1024 * 1024)
        return max(self._multipart_threshold, by_count)

    def _part_hash(self, stream: BinaryIO, start: int, length: int) -> str:
        """sha256 of one part's window, restoring the stream position."""
        digest = hashlib.sha256()
        stream.seek(start)
        remaining = length
        while remaining > 0:
            chunk = stream.read(min(_STREAM_CHUNK, remaining))
            if not chunk:
                break
            digest.update(chunk)
            remaining -= len(chunk)
        stream.seek(start)
        return digest.hexdigest()

    def initiate_multipart(  # protocol: multipart-upload acquire
        self,
        bucket: str,
        key: str,
        content_type: str = "application/octet-stream",
        token: CancelToken | None = None,
    ) -> str:
        """Start a multipart upload and return its UploadId. Parts may
        then ship in ANY order (S3 parts are independent — the
        streaming pipeline exploits this for out-of-order piece spans);
        the caller owns completing or aborting the upload."""
        if FAILPOINTS.fire("s3.initiate"):
            raise S3Error(503, "failpoint: s3.initiate unavailable")
        status, body, _ = self._request(
            "POST",
            self._object_path(bucket, key),
            query={"uploads": ""},
            content_type=content_type,
            token=token,
        )
        if status != 200:
            raise S3Error(status, body.decode(errors="replace")[:200])
        match = _UPLOAD_ID_RE.search(body)
        if not match:
            raise S3Error(status, "initiate multipart: no UploadId in response")
        return match.group(1).decode()

    def upload_part(
        self,
        bucket: str,
        key: str,
        upload_id: str,
        number: int,
        stream: BinaryIO,
        length: int,
        token: CancelToken | None = None,
        sign_payload: bool = False,
    ) -> str:
        """PUT one part (1-indexed) from the stream's current position;
        returns the ETag for the Complete manifest. Transient failures
        (5xx, connection drop) get ONE in-place retry when the stream
        can be rewound — a multi-GB upload should not restart because a
        single part hit a blip."""
        start = stream.tell() if _seekable(stream) else None
        payload_hash = (
            sigv4.EMPTY_SHA256
            if self._credentials.anonymous
            else "UNSIGNED-PAYLOAD"
        )
        if sign_payload and not self._credentials.anonymous and start is not None:
            payload_hash = self._part_hash(stream, start, length)
        last_error: Exception | None = None
        for attempt in range(2):
            if token is not None:
                token.raise_if_cancelled()
            if attempt and start is not None:
                stream.seek(start)
            if FAILPOINTS.fire("s3.part_put"):
                # an injected 5xx: the client's own one-retry-per-part
                # policy engages exactly as for a real server error
                last_error = S3Error(500, f"part {number}: failpoint 5xx")
                continue
            try:
                with tracing.span("s3-part", part=number, bytes=length):
                    status, body, headers = self._request(
                        "PUT",
                        self._object_path(bucket, key),
                        query={
                            "partNumber": str(number),
                            "uploadId": upload_id,
                        },
                        body=stream,
                        content_length=length,
                        payload_hash=payload_hash,
                        token=token,
                    )
            except (OSError, http.client.HTTPException) as exc:
                last_error = exc
                if start is None:
                    raise S3Error(0, f"part {number}: {exc}") from exc
                continue
            if status in (200, 201, 204):
                etag = headers.get("etag", "")
                if not etag:
                    raise S3Error(status, f"part {number}: no ETag in response")
                return etag
            message = f"part {number}: " + body.decode(errors="replace")[:200]
            if status < 500 or start is None:
                raise S3Error(status, message)
            last_error = S3Error(status, message)
        if isinstance(last_error, S3Error):
            raise last_error
        raise S3Error(0, f"part {number}: {last_error}")

    def complete_multipart(  # protocol: multipart-upload release bind=upload_id may-raise
        self,
        bucket: str,
        key: str,
        upload_id: str,
        parts: list[tuple[int, str]],
        token: CancelToken | None = None,
    ) -> None:
        """Assemble the uploaded parts. ``parts`` is (number, etag) in
        any order; the manifest is sorted — S3 requires ascending part
        numbers even though the uploads themselves were unordered."""
        manifest = "".join(
            f"<Part><PartNumber>{number}</PartNumber>"
            f"<ETag>{etag}</ETag></Part>"
            for number, etag in sorted(parts)
        )
        complete = (
            f"<CompleteMultipartUpload>{manifest}</CompleteMultipartUpload>"
        ).encode()
        status, body, _ = self._request(
            "POST",
            self._object_path(bucket, key),
            query={"uploadId": upload_id},
            body=io.BytesIO(complete),
            content_length=len(complete),
            payload_hash=hashlib.sha256(complete).hexdigest(),
            content_type="application/xml",
            token=token,
        )
        # S3 can answer Complete with 200 + an <Error> document, so
        # the status alone does not mean success
        if status != 200 or b"<Error>" in body:
            raise S3Error(status, body.decode(errors="replace")[:200])

    def list_multipart_uploads(
        self, bucket: str, prefix: str = ""
    ) -> "list[tuple[str, str]]":
        """In-progress multipart uploads as (key, upload_id) pairs —
        S3 ListMultipartUploads, path-style. The crash-only janitor
        reads this: a worker SIGKILLed mid-stream leaves its initiated
        upload dangling (nothing in-process survives to abort it), and
        the redelivered job is the first actor that knows the key is
        its to reclaim."""
        query: dict[str, str] = {"uploads": ""}
        if prefix:
            query["prefix"] = prefix
        status, body, _ = self._request("GET", f"/{bucket}", query=query)
        if status != 200:
            raise S3Error(status, body.decode(errors="replace")[:200])
        return [
            (key.decode(errors="replace"), upload_id.decode())
            for key, upload_id in _UPLOAD_ENTRY_RE.findall(body)
        ]

    def abort_stale_multiparts(self, bucket: str, key: str) -> int:
        """Crash janitor: abort every in-progress multipart upload for
        EXACTLY ``key`` and return how many were reclaimed. Called by
        the streaming pipeline before it initiates its own upload for a
        key — at-least-once redelivery makes the re-running job the
        key's sole owner, so anything already in flight is a dead
        worker's orphan (a concurrent duplicate delivery losing its
        upload here just retries, which at-least-once already absorbs).
        A store that cannot list (ancient stub, denied permission)
        costs nothing: the caller proceeds and real S3's lifecycle
        rules remain the backstop."""
        try:
            stale = [
                upload_id
                for got_key, upload_id in self.list_multipart_uploads(
                    bucket, prefix=key
                )
                if got_key == key
            ]
        except (S3Error, OSError, http.client.HTTPException) as exc:
            log.with_fields(key=key).debug(
                f"stale-multipart listing unavailable ({exc})"
            )
            return 0
        reclaimed = 0
        for upload_id in stale:
            try:
                self.abort_multipart(bucket, key, upload_id)
                reclaimed += 1
            except (S3Error, OSError, http.client.HTTPException) as exc:
                log.with_fields(key=key).warning(
                    f"failed to abort stale multipart {upload_id}: {exc}"
                )
        if reclaimed:
            from ..utils import metrics

            metrics.GLOBAL.add("multipart_stale_aborts", reclaimed)
            log.with_fields(key=key, count=reclaimed).warning(
                "aborted stale multipart uploads left by a dead worker"
            )
        return reclaimed

    def abort_multipart(self, bucket: str, key: str, upload_id: str) -> None:  # protocol: multipart-upload release bind=upload_id
        """Abort an in-progress multipart upload so the store doesn't
        accrue orphaned part storage. Deliberately token-free — aborts
        must run even ON cancellation — with a short timeout so a
        black-holed endpoint can't park a cancelled caller for the full
        client timeout. 404 (already gone) counts as success."""
        status, body, _ = self._request(
            "DELETE",
            self._object_path(bucket, key),
            query={"uploadId": upload_id},
            timeout=min(self._timeout, 5.0),
        )
        if status not in (200, 204, 404):
            raise S3Error(status, body.decode(errors="replace")[:200])

    def _put_multipart(
        self,
        bucket: str,
        key: str,
        stream: BinaryIO,
        size: int,
        content_type: str,
        token: CancelToken | None,
        sign_payload: bool = False,
    ) -> None:
        """Sequential store-and-forward multipart: the whole object is
        already on disk (or spooled), so parts ship in order off one
        stream. The streaming pipeline drives the same initiate/part/
        complete/abort API out of order instead."""
        # crash janitor, same as the streaming lane: a worker SIGKILLed
        # mid-multipart left nothing alive to abort, and the
        # redelivered job re-uploading this key is its new sole owner —
        # zero dangling multiparts must hold on BOTH upload lanes
        self.abort_stale_multiparts(bucket, key)
        upload_id = self.initiate_multipart(
            bucket, key, content_type=content_type, token=token
        )
        part_size = self._derived_part_size(size)
        base = stream.tell()
        try:
            etags: list[tuple[int, str]] = []
            offset = 0
            while offset < size:
                if token is not None:
                    token.raise_if_cancelled()
                length = min(part_size, size - offset)
                number = len(etags) + 1
                stream.seek(base + offset)
                etags.append(
                    (
                        number,
                        self.upload_part(
                            bucket,
                            key,
                            upload_id,
                            number,
                            stream,
                            length,
                            token=token,
                            sign_payload=sign_payload,
                        ),
                    )
                )
                offset += length
            self.complete_multipart(bucket, key, upload_id, etags, token=token)
        except BaseException:
            # best-effort: prompt teardown beats a guaranteed abort,
            # but a failed abort leaves orphaned part storage accruing
            # charges — worth a breadcrumb even while re-raising the
            # original error
            try:
                self.abort_multipart(bucket, key, upload_id)
            except (S3Error, OSError, http.client.HTTPException) as exc:
                # HTTPException included: _request re-raises it unwrapped
                # (e.g. BadStatusLine from a half-closed origin), and it
                # escaping here would REPLACE the original upload error
                log.debug(f"abort-multipart for {key} failed: {exc}")
            raise
