"""Native Google Cloud Storage backend.

Capability parity: reference storehouse GCSStorage
(scanner/util/storehouse.h; python config.py:56 selects "gcs") — the
production store for 1000-video corpora.  Unlike gcsfuse-over-POSIX this
speaks the GCS API directly: ranged reads for sparse row fetches
(items.read_item_rows), resumable chunked uploads for large items, and
generation preconditions for the atomic first-writer-wins marker
(`write_exclusive`, if_generation_match=0) that POSIX gets from
O_CREAT|O_EXCL.

GCS object visibility is atomic (an object never appears partially
written), which satisfies the StorageBackend atomicity contract without a
rename step.  The client is injectable so unit tests run against an
in-memory fake; nothing imports google.cloud at module import time.
"""

from __future__ import annotations

from typing import List, Optional

from ..common import StorageException
from ..util import faults as _faults
from ..util.retry import call_with_backoff
from .backend import StorageBackend

# resumable-upload chunk size; also the threshold above which the client
# library switches from one-shot to resumable uploads
_CHUNK_SIZE = 16 * 1024 * 1024

# transient service errors worth retrying (rate limit + server-side);
# matched structurally so fakes don't need the google exception classes
_TRANSIENT_CODES = {429, 500, 502, 503, 504}
_TRANSIENT_NAMES = {"TooManyRequests", "InternalServerError", "BadGateway",
                    "ServiceUnavailable", "GatewayTimeout",
                    "DeadlineExceeded", "RetryError"}


def _transient(e: Exception) -> bool:
    return getattr(e, "code", None) in _TRANSIENT_CODES \
        or type(e).__name__ in _TRANSIENT_NAMES \
        or isinstance(e, ConnectionError)


def parse_gs_url(url: str):
    """'gs://bucket/some/prefix' -> (bucket, 'some/prefix')."""
    if not url.startswith("gs://"):
        raise StorageException(f"not a gs:// url: {url}")
    rest = url[len("gs://"):]
    bucket, _, prefix = rest.partition("/")
    if not bucket:
        raise StorageException(f"gs:// url missing bucket: {url}")
    return bucket, prefix.strip("/")


class GcsStorage(StorageBackend):
    """Blobs are GCS objects under gs://bucket/prefix/."""

    def __init__(self, bucket: str, prefix: str = "",
                 client=None, retries: int = 5,
                 backoff_base: float = 0.1, backoff_cap: float = 5.0):
        self._retries = retries
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        if client is None:
            try:
                from google.cloud import storage as gcs
            except ImportError as e:  # pragma: no cover - env without lib
                raise StorageException(
                    "google-cloud-storage is required for the gcs "
                    "backend") from e
            client = gcs.Client()
        self._client = client
        self._bucket = client.bucket(bucket)
        self.prefix = prefix.strip("/")

    @staticmethod
    def from_url(url: str, client=None) -> "GcsStorage":
        bucket, prefix = parse_gs_url(url)
        return GcsStorage(bucket, prefix, client=client)

    def _key(self, path: str) -> str:
        path = path.lstrip("/")
        if not self.prefix:
            return path
        return f"{self.prefix}/{path}" if path else self.prefix

    def _blob(self, path: str, chunked: bool = False):
        blob = self._bucket.blob(self._key(path))
        if chunked:
            blob.chunk_size = _CHUNK_SIZE
        return blob

    @staticmethod
    def _not_found(e: Exception) -> bool:
        # google.api_core.exceptions.NotFound has code 404; tested
        # structurally so fakes don't need the real exception class
        return getattr(e, "code", None) == 404 \
            or type(e).__name__ == "NotFound"

    @staticmethod
    def _precondition_failed(e: Exception) -> bool:
        return getattr(e, "code", None) == 412 \
            or type(e).__name__ == "PreconditionFailed"

    def _with_retry(self, fn):
        """Run fn() retrying transient 429/5xx/connection errors with
        full-jitter exponential backoff (storehouse retry parity).
        Retries count into scanner_tpu_retry_attempts_total{site="gcs"}
        and the final give-up logs at WARNING with the accumulated wait
        (util/retry.py) — a throttled bucket is visible live, not only
        as mysteriously slow tasks."""

        def attempt():
            # chaos hook fires per ATTEMPT (inside the backoff loop), so
            # an injected transient error exercises this retry path
            if _faults.ACTIVE:
                _faults.inject("gcs.request")
            return fn()

        return call_with_backoff(
            attempt, is_transient=_transient, retries=self._retries,
            base=self._backoff_base, cap=self._backoff_cap, label="gcs")

    # -- reads ----------------------------------------------------------

    def read(self, path: str) -> bytes:
        try:
            return self._with_retry(
                lambda: self._blob(path).download_as_bytes())
        except Exception as e:  # noqa: BLE001
            if self._not_found(e):
                raise StorageException(f"not found: {path}") from e
            raise

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        def fetch(start: int, want: int) -> bytes:
            try:
                # GCS range end is INCLUSIVE
                return self._with_retry(
                    lambda: self._blob(path).download_as_bytes(
                        start=start, end=start + want - 1))
            except Exception as e:  # noqa: BLE001
                if self._not_found(e):
                    raise StorageException(f"not found: {path}") from e
                # requesting past EOF returns 416; mirror POSIX short read
                if getattr(e, "code", None) == 416:
                    return b""
                raise

        if size <= 0:
            return b""
        # a truncated transfer surfaces as a short byte string; re-issue
        # the remaining range until EOF (empty/unchanged) or complete
        out = fetch(offset, size)
        while 0 < len(out) < size:
            more = fetch(offset + len(out), size - len(out))
            if not more:
                break  # genuine EOF — short read mirrors POSIX
            out += more
        return out

    # -- writes ---------------------------------------------------------

    def write(self, path: str, data: bytes, sync: bool = True) -> None:
        # resumable chunked upload above _CHUNK_SIZE; object visibility
        # is atomic either way.  Retry-safe: re-uploading the same bytes
        # is idempotent.  `sync` is meaningless here (GCS objects are
        # durable at acknowledgment); accepted for interface parity.
        self._with_retry(
            lambda: self._blob(path, chunked=len(data) > _CHUNK_SIZE)
            .upload_from_string(bytes(data),
                                content_type="application/octet-stream"))

    def write_exclusive(self, path: str, data: bytes) -> bool:
        try:
            # NOT retried wholesale: a retry after an ambiguous transient
            # failure could observe its OWN first attempt's object and
            # misreport "lost the race".  if_generation_match=0 makes the
            # server reject duplicates, so only connection-refused (never
            # sent) errors are safe to retry — covered by _transient on
            # the underlying channel inside one upload call.
            self._blob(path).upload_from_string(
                bytes(data), content_type="application/octet-stream",
                if_generation_match=0)
            return True
        except Exception as e:  # noqa: BLE001
            if self._precondition_failed(e):
                return False
            raise

    # -- metadata/management --------------------------------------------

    def exists(self, path: str) -> bool:
        return bool(self._with_retry(lambda: self._blob(path).exists()))

    def size(self, path: str) -> int:
        blob = self._with_retry(
            lambda: self._bucket.get_blob(self._key(path)))
        if blob is None:
            raise StorageException(f"not found: {path}")
        return int(blob.size)

    def delete(self, path: str) -> None:
        try:
            self._with_retry(lambda: self._blob(path).delete())
        except Exception as e:  # noqa: BLE001
            if not self._not_found(e):
                raise

    @staticmethod
    def _under(name: str, key: str) -> bool:
        """Path-component-boundary prefix match: 'tables/5' covers
        'tables/5' and 'tables/5/...' but NOT 'tables/52/...' (object
        stores have no directories; a raw string prefix would silently
        hit sibling tables)."""
        if not key:
            return True
        return name == key or name.startswith(key + "/")

    def delete_prefix(self, prefix: str) -> None:
        key = self._key(prefix)
        blobs = self._with_retry(
            lambda: list(self._client.list_blobs(self._bucket, prefix=key)))
        for blob in blobs:
            if not self._under(blob.name, key):
                continue
            try:
                self._with_retry(blob.delete)
            except Exception as e:  # noqa: BLE001
                if not self._not_found(e):
                    raise

    def list_prefix(self, prefix: str) -> List[str]:
        root = self._key(prefix)
        strip = len(self.prefix) + 1 if self.prefix else 0
        blobs = self._with_retry(
            lambda: list(self._client.list_blobs(self._bucket,
                                                 prefix=root)))
        return sorted(blob.name[strip:] for blob in blobs
                      if self._under(blob.name, root))
