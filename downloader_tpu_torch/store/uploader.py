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
  file at a time (the reference is strictly serial).

The port leaves out the JAX package's streaming-pipeline hand-off:
``configure_pipeline``, ``streaming_session``, the ``close`` that
releases the pipeline and ``upload_files``'s ``streamed`` map of files
the pipeline already stored. The queue-driven daemon is their only
caller, and they come with it. ``batch_scope`` (the batched
small-object path) and ``read_back`` (the canary) come with their
callers too.
"""

from __future__ import annotations

import base64
import io
import os
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

    def upload_files(
        self,
        token: CancelToken,
        media_id: str,
        files: list[str],
    ) -> UploadResult:
        """Upload the batch."""
        pending = list(files)
        if pending:
            # nothing to upload → no bucket round trip; empty batches
            # (media-less jobs) return immediately
            self._ensure_bucket()
        result = UploadResult()

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
