"""Media uploader: push scanned files to the object store.

Rebuild of the reference's ``internal/uploader`` (uploader.go:24-97):

- Client built from ``S3_ENDPOINT`` (scheme selects TLS, uploader.go:32-36)
  and the env credential chain (credentials.py).
- ``upload_files``: ensure the bucket exists, creating it best-effort with
  a warning on failure (uploader.go:64-70); upload each file to
  ``<media_id>/original/<base64(basename)>`` — base64 so arbitrary media
  names can't produce invalid object keys (uploader.go:86-89); per-file
  failures are logged and skipped (uploader.go:74-91).

Upgrades over the reference (its own TODO, uploader.go:61):

- the result reports which files uploaded and which failed, and the call
  raises UploadError if every file failed, so the daemon can leave the
  job unacked/retryable instead of acking a wholly failed upload;
- multi-file batches upload through a small bounded pool instead of one
  file at a time (the reference is strictly serial);
- files already shipped by the streaming pipeline (store/pipeline.py)
  during the fetch are recognized and skipped — ``upload_files`` is the
  store-and-forward fallback half of that pipeline.
"""

from __future__ import annotations

import base64
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..utils import get_logger, metrics, tracing, watchdog
from ..utils.cancel import CancelToken
from ..utils.failpoints import FAILPOINTS
from .credentials import from_env
from .s3 import S3Client, S3Error

log = get_logger("store")

# files per batch uploaded concurrently; deliberately small — per-file
# concurrency multiplies against job concurrency and the streaming
# pipeline's part pool, and most jobs have a single payload anyway
DEFAULT_UPLOAD_WORKERS = 4


class UploadError(Exception):
    """Raised when no file of a non-empty batch could be uploaded."""


@dataclass
class UploadResult:
    uploaded: list[tuple[str, str]] = field(default_factory=list)  # (path, key)
    failed: list[tuple[str, str]] = field(default_factory=list)  # (path, error)


def object_key(media_id: str, file_path: str) -> str:
    encoded = base64.b64encode(os.path.basename(file_path).encode()).decode()
    return f"{media_id}/original/{encoded}"


class Uploader:
    def __init__(
        self,
        bucket: str,
        client: S3Client,
        upload_workers: int = DEFAULT_UPLOAD_WORKERS,
        pipeline: "object | None" = None,
    ):
        self._bucket = bucket
        self._client = client
        self._upload_workers = max(1, upload_workers)
        # bucket existence confirmed once per process, not per job: the
        # span traces showed every job paying a bucket_exists round trip
        # (~1-4 ms of pure per-job overhead at loopback, worse against
        # real S3) for a bucket that exists for the daemon's lifetime.
        # If the bucket vanishes mid-run, the puts fail with a clear
        # S3Error and the job retries — at-least-once either way.
        self._bucket_ensured = False
        # the streaming fetch→upload pipeline; built lazily from env
        # unless injected, so library users and tests that never call
        # streaming_session() pay nothing for it
        self._pipeline = pipeline
        self._pipeline_lock = threading.Lock()

    @classmethod
    def from_env(cls, bucket: str) -> "Uploader":
        endpoint = os.environ.get("S3_ENDPOINT", "")
        client = S3Client.from_endpoint_url(endpoint, from_env())
        return cls(bucket, client)

    def _ensure_bucket(self) -> None:
        if self._bucket_ensured:
            return
        try:
            if self._client.bucket_exists(self._bucket):
                self._bucket_ensured = True
                return
        except S3Error as exc:
            log.warning(f"failed to check bucket: {exc}")
            return
        try:
            self._client.make_bucket(self._bucket)
            self._bucket_ensured = True
            log.info("created bucket")
        except S3Error as exc:
            # best-effort, like the reference (uploader.go:66-69)
            log.warning(f"failed to create bucket: {exc}")

    # -- streaming pipeline hand-off --------------------------------------

    def configure_pipeline(
        self, enabled: bool, part_workers: int | None = None
    ) -> None:
        """Explicitly (re)build the streaming pipeline instead of the
        lazy from-env default — how the bench pins its pipelined vs
        store-and-forward arms regardless of the environment."""
        from .pipeline import StreamingPipeline

        with self._pipeline_lock:
            previous = self._pipeline
            self._pipeline = StreamingPipeline(
                self._client,
                self._bucket,
                enabled=enabled,
                part_workers=part_workers,
                prepare=self._ensure_bucket,
            )
        if previous is not None:
            previous.close()

    def streaming_session(self, media_id: str, token: CancelToken | None = None):
        """A per-job PipelineSession for speculative streamed uploads,
        or None when the pipeline is disabled (PIPELINE=off). The
        daemon installs the session as the job's transfer sink and
        MUST call ``close()`` on it in a finally."""
        with self._pipeline_lock:
            if self._pipeline is None:
                from .pipeline import StreamingPipeline

                self._pipeline = StreamingPipeline(
                    self._client, self._bucket, prepare=self._ensure_bucket
                )
            pipeline = self._pipeline
        return pipeline.session(media_id, token)

    def batch_scope(self):
        """One store connection for every upload the calling thread
        issues inside the scope (S3Client.connection_scope): the
        batched small-object fast path wraps a whole batch so N
        single-PUT uploads pay one handshake. Single-file jobs upload
        on the calling thread (see upload_files), so the scope covers
        exactly the batch's PUTs."""
        return self._client.connection_scope()

    def close(self) -> None:
        """Release the streaming pipeline's part pool (daemon shutdown)."""
        with self._pipeline_lock:
            pipeline, created = self._pipeline, self._pipeline is not None
        if created:
            close = getattr(pipeline, "close", None)
            if close is not None:
                close()

    # -- store-and-forward batch upload -----------------------------------

    def _upload_one(self, token: CancelToken, file_path: str, key: str) -> int:
        """Upload one file; returns its size. Exceptions propagate to
        the batch loop which folds them into the result."""
        token.raise_if_cancelled()
        size = os.stat(file_path).st_size
        if FAILPOINTS.fire("canary.corrupt"):
            # silent corruption PAST every digest check: the fetched
            # file on disk verified clean, the upload "succeeds" with
            # the same size, but the stored first byte is flipped —
            # exactly the failure only the canary read-back can catch
            with open(file_path, "rb") as stream:
                body = bytearray(stream.read())
            if body:
                body[0] ^= 0xFF
            with tracing.span("upload-file", key=key, size=size):
                self._client.put_object(
                    self._bucket, key, io.BytesIO(bytes(body)), size, token=token
                )
            log.info("finished upload")
            return size
        with open(file_path, "rb") as stream, tracing.span(
            "upload-file", key=key, size=size
        ):
            log.with_fields(key=key, size=size).info("starting upload of file")
            self._client.put_object(self._bucket, key, stream, size, token=token)
        log.info("finished upload")
        return size

    def read_back(self, key: str) -> bytes:
        """Outside-in fetch of a stored object's bytes — the canary
        verifier's integrity lane (utils/canary.py). Deliberately NOT
        routed through any cache or pipeline state: it must see
        exactly what the store would serve a downstream consumer."""
        return self._client.get_object(self._bucket, key)

    def upload_files(
        self,
        token: CancelToken,
        media_id: str,
        files: list[str],
        streamed: dict[str, str] | None = None,
    ) -> UploadResult:
        """Upload the batch; ``streamed`` maps paths the pipeline
        already landed in the store to their keys — they are recorded
        as uploaded without a second pass over the bytes."""
        streamed = streamed or {}
        pending = [path for path in files if path not in streamed]
        if pending:
            # nothing to upload → no bucket round trip; empty batches
            # (media-less jobs) return immediately
            self._ensure_bucket()
        result = UploadResult()
        for path, key in streamed.items():
            if path in files:
                result.uploaded.append((path, key))

        # slot results by index so the outcome ordering is deterministic
        # regardless of which worker finishes first
        outcomes: list[tuple[str, str, Exception | None] | None]
        outcomes = [None] * len(pending)

        # stall-watchdog heartbeat for the store-and-forward path:
        # captured on the job thread, beaten per settled file from the
        # pool workers (a failed upload is still forward progress — the
        # batch is moving; only silence means wedged)
        upload_hb = watchdog.current().heartbeat("upload")

        def upload_at(index: int) -> None:
            file_path = pending[index]
            key = object_key(media_id, file_path)
            try:
                size = self._upload_one(token, file_path, key)
            except (OSError, S3Error) as exc:
                outcomes[index] = (file_path, key, exc)
                upload_hb.beat()
                return
            metrics.GLOBAL.add("s3_bytes_uploaded", size)
            metrics.GLOBAL.add("s3_objects_uploaded")
            outcomes[index] = (file_path, key, None)
            upload_hb.beat()

        if len(pending) <= 1:
            for index in range(len(pending)):
                upload_at(index)  # no pool spin-up for the common case
        else:
            workers = min(self._upload_workers, len(pending))
            parent = tracing.current_span()
            with ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="upload"
            ) as pool:
                def traced_upload_at(index: int) -> None:
                    with tracing.adopt(parent):
                        upload_at(index)

                list(pool.map(traced_upload_at, range(len(pending))))

        token.raise_if_cancelled()  # a cancelled batch must raise, not report
        for outcome in outcomes:
            if outcome is None:  # unreachable unless a worker died raw
                continue
            file_path, key, error = outcome
            if error is None:
                result.uploaded.append((file_path, key))
                continue
            log.error(f"failed to upload file '{file_path}'", exc=error)
            result.failed.append((file_path, str(error)))
            if isinstance(error, S3Error):
                # re-arm the bucket check: a bucket deleted mid-run
                # (lifecycle policy, operator cleanup) must be
                # auto-recreated on the retry, as it was before the
                # once-per-process cache — otherwise every later
                # job burns its retry budget against NoSuchBucket
                self._bucket_ensured = False

        if files and not result.uploaded:
            raise UploadError(
                f"all {len(result.failed)} uploads failed for media '{media_id}'"
            )
        return result
