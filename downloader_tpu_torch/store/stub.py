"""In-memory S3-compatible stub server, for hermetic tests and benchmarks.

The reference has no test double for its uploader (SURVEY.md §4 notes zero
uploader tests); this stub is the rebuild's answer — a real HTTP server
speaking just enough S3 (HEAD/PUT bucket, PUT/GET object, the multipart
upload API, path-style) to exercise the client end-to-end, including SigV4
verification: when constructed with credentials it recomputes the signature
from the received request and rejects mismatches with 403, so
canonicalization bugs in the client surface as test failures.
"""

from __future__ import annotations

import hashlib
import http.server
import re
import socket
import threading
import urllib.parse

from . import sigv4
from .credentials import Credentials

_AUTH_RE = re.compile(
    r"AWS4-HMAC-SHA256 Credential=(?P<access>[^/]+)/(?P<date>\d{8})/"
    r"(?P<region>[^/]+)/(?P<service>[^/]+)/aws4_request, "
    r"SignedHeaders=(?P<signed>[^,]+), Signature=(?P<signature>[0-9a-f]{64})"
)


class S3Stub:
    def __init__(
        self,
        credentials: Credentials | None = None,
        retain_objects: bool = True,
    ):
        """``retain_objects=False`` drains PUT bodies into a reusable
        scratch buffer and stores only the received length. Benchmarks
        need this: retaining every multi-MB body makes each subsequent
        large ``bytearray(length)`` allocation progressively slower
        (fresh-page faulting as RSS grows — measured decaying from ~1 GB/s
        to ~100 MB/s over 8 × 256 MB PUTs on a 1-vCPU host), so a
        retaining stub measures its own memory behavior instead of the
        client under test. Functional tests keep the default and can GET
        objects back."""
        self.credentials = credentials
        self.retain_objects = retain_objects
        self.buckets: dict[str, dict[str, bytes]] = {}
        # pending multipart uploads: (bucket, key, upload_id) ->
        # {part_number: (etag, body)}; completed_multiparts counts
        # assemblies so tests can assert the multipart path actually ran
        self.uploads: dict[tuple[str, str, str], dict[int, tuple[str, bytes]]] = {}
        self.completed_multiparts = 0
        self._upload_seq = 0
        self.lock = threading.Lock()
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _reject(self, status: int, message: str = "") -> None:
                body = message.encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_body(self) -> bytes | bytearray:
                length = int(self.headers.get("Content-Length", "0"))
                if not length:
                    return b""
                # readinto a preallocated buffer: one copy per byte, no
                # chunk-list churn (peak memory is the full body either
                # way — objects are stored in memory)
                body = bytearray(length)
                with memoryview(body) as view:
                    read = 0
                    while read < length:
                        got = self.rfile.readinto(view[read:])
                        if not got:
                            break
                        read += got
                # bytearray supports everything downstream (hashing,
                # storage, wfile.write); skip a full-body copy on 1 vCPU
                del body[read:]
                return body

            def _drain_body(self) -> tuple[int, str]:
                """Read and discard the request body; returns
                (bytes read, sha256 hex) so auth can still verify
                signed payloads without retaining them.

                Unsigned bodies (the client's streaming default) are
                discarded KERNEL-SIDE with recv(MSG_TRUNC) — Linux TCP
                consumes the bytes without copying them to userspace —
                so the stub models a remote peer instead of competing
                with the client under test for this host's one vCPU.
                Signed bodies still stream through userspace (sha256
                needs the bytes), as does any platform where MSG_TRUNC
                misbehaves."""
                length = int(self.headers.get("Content-Length", "0"))
                # hash only when the client signed the payload; the
                # common UNSIGNED-PAYLOAD path must not pay sha256 here
                signed = self.headers.get(
                    "x-amz-content-sha256", sigv4.EMPTY_SHA256
                ) not in ("UNSIGNED-PAYLOAD",)
                digest = hashlib.sha256() if signed else None
                read = 0
                scratch = memoryview(bytearray(1024 * 1024))
                if digest is None and length:
                    # `length` guard: peek blocks on an empty buffer
                    # waiting for bytes a zero-length body never sends.
                    # The header parser's BufferedReader may already
                    # hold body bytes; those must come from the buffer
                    # or the raw-socket discard would break framing.
                    # ONE peek only — peek refills an empty buffer with
                    # a raw read, so peeking in a loop would pull the
                    # whole body through 8 KiB buffer fills and never
                    # reach the kernel-side discard below
                    buffered = self.rfile.peek(0)
                    if buffered and read < length:
                        take = min(len(buffered), length - read)
                        self.rfile.read(take)
                        read += take
                    try:
                        while read < length:
                            # recv_into + MSG_TRUNC: the kernel consumes
                            # the bytes without filling the buffer, and
                            # the reused scratch avoids a fresh 1 MiB
                            # allocation per call (recv would allocate)
                            got = self.connection.recv_into(
                                scratch,
                                min(len(scratch), length - read),
                                socket.MSG_TRUNC,
                            )
                            if not got:
                                return read, ""
                            read += got
                        return read, ""
                    except (OSError, ValueError):
                        pass  # MSG_TRUNC unsupported: userspace fallback
                while read < length:
                    got = self.rfile.readinto(
                        scratch[: min(len(scratch), length - read)]
                    )
                    if not got:
                        break
                    if digest is not None:
                        digest.update(scratch[:got])
                    read += got
                return read, digest.hexdigest() if digest is not None else ""

            def _verify_auth(self, body: bytes, digest: str | None = None) -> bool:
                if stub.credentials is None or stub.credentials.anonymous:
                    return True
                match = _AUTH_RE.match(self.headers.get("Authorization", ""))
                if not match or match["access"] != stub.credentials.access_key:
                    return False
                headers = {
                    name: self.headers[name]
                    for name in match["signed"].split(";")
                    if name in self.headers
                }
                payload_hash = self.headers.get(
                    "x-amz-content-sha256", sigv4.EMPTY_SHA256
                )
                if payload_hash not in ("UNSIGNED-PAYLOAD",):
                    received = (
                        digest
                        if digest is not None
                        else hashlib.sha256(body).hexdigest()
                    )
                    if received != payload_hash:
                        return False
                parsed = urllib.parse.urlparse(self.path)
                expected = sigv4.sign(
                    self.command,
                    urllib.parse.unquote(parsed.path),
                    self._query(),
                    headers,
                    payload_hash,
                    stub.credentials.access_key,
                    stub.credentials.secret_key,
                    match["region"],
                    match["service"],
                    self.headers.get("x-amz-date", ""),
                )
                return expected.endswith(match["signature"])

            def _route(self) -> tuple[str, str]:
                path = urllib.parse.unquote(urllib.parse.urlparse(self.path).path)
                parts = path.lstrip("/").split("/", 1)
                bucket = parts[0]
                key = parts[1] if len(parts) > 1 else ""
                return bucket, key

            def _query(self) -> dict[str, str]:
                # keep_blank_values: '?uploads=' signs as {'uploads': ''}
                # and dropping it would recompute a different signature
                # in _verify_auth (and mis-route multipart initiates)
                return dict(
                    urllib.parse.parse_qsl(
                        urllib.parse.urlparse(self.path).query,
                        keep_blank_values=True,
                    )
                )

            def do_HEAD(self):
                bucket, key = self._route()
                with stub.lock:
                    if key:
                        exists = key in stub.buckets.get(bucket, {})
                    else:
                        exists = bucket in stub.buckets
                self._reject(200 if exists else 404)

            def do_PUT(self):
                if stub.retain_objects:
                    body: bytes | bytearray = self._read_body()
                    digest = None
                    read = len(body)
                else:
                    read, digest = self._drain_body()
                    body = b""
                if not self._verify_auth(body, digest):
                    self._reject(403, "SignatureDoesNotMatch")
                    return
                bucket, key = self._route()
                query = self._query()
                if "partNumber" in query and "uploadId" in query:
                    self._put_part(bucket, key, query, bytes(body), read)
                    return
                with stub.lock:
                    if not key:
                        stub.buckets.setdefault(bucket, {})
                        self._reject(200)
                        return
                    if bucket not in stub.buckets:
                        self._reject(404, "NoSuchBucket")
                        return
                    stub.buckets[bucket][key] = body
                self._reject(200)

            def _put_part(
                self,
                bucket: str,
                key: str,
                query: dict[str, str],
                body: bytes,
                read: int,
            ) -> None:
                upload = (bucket, key, query["uploadId"])
                # real S3 ETags for simple parts are the MD5; in drain
                # mode there is no body, so tag by length — the client
                # treats the value as opaque and echoes it on Complete
                etag = (
                    '"%s"' % hashlib.md5(body).hexdigest()
                    if stub.retain_objects
                    else f'"len-{read}"'
                )
                with stub.lock:
                    parts = stub.uploads.get(upload)
                    if parts is None:
                        self._reject(404, "NoSuchUpload")
                        return
                    parts[int(query["partNumber"])] = (etag, body)
                self.send_response(200)
                self.send_header("ETag", etag)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                body = bytes(self._read_body())
                if not self._verify_auth(body):
                    self._reject(403, "SignatureDoesNotMatch")
                    return
                bucket, key = self._route()
                query = self._query()
                if "uploads" in query:
                    with stub.lock:
                        if bucket not in stub.buckets:
                            self._reject(404, "NoSuchBucket")
                            return
                        stub._upload_seq += 1
                        upload_id = f"upload-{stub._upload_seq}"
                        stub.uploads[(bucket, key, upload_id)] = {}
                    payload = (
                        "<InitiateMultipartUploadResult>"
                        f"<Bucket>{bucket}</Bucket><Key>{key}</Key>"
                        f"<UploadId>{upload_id}</UploadId>"
                        "</InitiateMultipartUploadResult>"
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if "uploadId" in query:
                    self._complete_multipart(bucket, key, query["uploadId"], body)
                    return
                self._reject(400, "unsupported POST")

            def _complete_multipart(
                self, bucket: str, key: str, upload_id: str, manifest: bytes
            ) -> None:
                claimed = re.findall(
                    rb"<PartNumber>(\d+)</PartNumber>\s*<ETag>([^<]+)</ETag>",
                    manifest,
                )
                with stub.lock:
                    parts = stub.uploads.pop((bucket, key, upload_id), None)
                    if parts is None:
                        self._reject(404, "NoSuchUpload")
                        return
                    for number_raw, etag_raw in claimed:
                        stored = parts.get(int(number_raw))
                        if stored is None or stored[0] != etag_raw.decode():
                            self._reject(400, "InvalidPart")
                            return
                    if len(claimed) != len(parts):
                        self._reject(400, "InvalidPartOrder")
                        return
                    assembled = b"".join(
                        parts[number][1] for number in sorted(parts)
                    )
                    stub.buckets.setdefault(bucket, {})[key] = assembled
                    stub.completed_multiparts += 1
                payload = (
                    "<CompleteMultipartUploadResult>"
                    f"<Bucket>{bucket}</Bucket><Key>{key}</Key>"
                    "</CompleteMultipartUploadResult>"
                ).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_DELETE(self):
                if not self._verify_auth(b""):
                    self._reject(403, "SignatureDoesNotMatch")
                    return
                bucket, key = self._route()
                query = self._query()
                if "uploadId" in query:
                    with stub.lock:
                        stub.uploads.pop((bucket, key, query["uploadId"]), None)
                    self._reject(204)
                    return
                self._reject(400, "unsupported DELETE")

            def do_GET(self):
                bucket, key = self._route()
                query = self._query()
                if "uploads" in query and not key:
                    # ListMultipartUploads: the crash janitor's read —
                    # pending uploads for the bucket (optionally
                    # prefix-filtered), S3 XML shape
                    prefix = query.get("prefix", "")
                    with stub.lock:
                        pending = [
                            (up_key, up_id)
                            for up_bucket, up_key, up_id in stub.uploads
                            if up_bucket == bucket
                            and up_key.startswith(prefix)
                        ]
                    entries = "".join(
                        f"<Upload><Key>{up_key}</Key>"
                        f"<UploadId>{up_id}</UploadId></Upload>"
                        for up_key, up_id in pending
                    )
                    payload = (
                        "<ListMultipartUploadsResult>"
                        f"<Bucket>{bucket}</Bucket>{entries}"
                        "</ListMultipartUploadsResult>"
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                with stub.lock:
                    data = stub.buckets.get(bucket, {}).get(key)
                if data is None:
                    self._reject(404, "NoSuchKey")
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def list_multipart_uploads(
        self, bucket: str | None = None
    ) -> list[tuple[str, str, str]]:
        """Pending (bucket, key, upload_id) triples — the stub's analogue
        of S3 ListMultipartUploads. Abort-path tests assert this is
        EMPTY after cancellation/failure/scan-rejection: a non-empty
        list is exactly the orphaned part storage a real account would
        be billed for."""
        with self.lock:
            return [
                upload
                for upload in self.uploads
                if bucket is None or upload[0] == bucket
            ]

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "S3Stub":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "S3Stub":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
