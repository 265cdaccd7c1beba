"""Remote BAM access over http(s) — the TPU-build counterpart of the reference's
HTSlib/libcurl remote-file backend (SURVEY.md §0.1 item 4: `ci.yml:26` installs libcurl for
remote BAM URLs, not IPC).

A minimal sequential binary stream via urllib with:
- buffered ``read(n)`` / ``tell()`` for streaming BGZF decode,
- ``seek(offset)`` via HTTP Range re-open (used by BGZF ``seek_virtual`` → mid-pass resume
  and per-host range sharding work on URLs exactly like on local files),
- bounded retry with exponential backoff + jitter on transient failures (connection resets,
  5xx, timeouts) — long WGS streams over flaky links must not kill an hour-long build;
  the stream re-opens at the exact byte offset it had reached,
- explicit scheme guidance for ``s3://`` / ``gs://`` (use presigned/public https URLs —
  authenticated object-store SDKs are out of scope by design; libcurl's s3 support in the
  reference likewise needs explicit credentials plumbing).

No third-party deps; servers without Range support raise on seek (streaming still works).

The port's copy of ``denovo_kmer_tpu/io/remote.py``; its imports point at the port.
"""

from __future__ import annotations

import io
import random
import time
import urllib.error
import urllib.request
from http.client import HTTPException
from typing import Optional

_CHUNK = 1 << 20

#: transient HTTP statuses worth retrying (server hiccup / throttling / gateway)
_RETRY_STATUS = {429, 500, 502, 503, 504}


def _is_transient(exc: BaseException) -> bool:
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in _RETRY_STATUS
    return isinstance(exc, (urllib.error.URLError, ConnectionError, HTTPException,
                            TimeoutError, OSError))


class HttpStream(io.RawIOBase):
    """Sequential+seekable http(s) byte stream with transparent retry.

    ``retries`` counts re-attempts per operation; backoff is exponential
    (``backoff * 2^attempt`` seconds, full jitter), matching the htslib/libcurl
    retry-on-transient behavior the reference inherits.
    """

    def __init__(self, url: str, timeout: float = 60.0, retries: int = 4,
                 backoff: float = 0.5, sign=None):
        self.url = url
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        #: optional per-request signer (io/objstore.py): called with the prepared
        #: urllib Request AFTER Range is set, so every re-open re-signs correctly
        self.sign = sign
        self._pos = 0
        self._resp = None
        self._buf = b""
        self._open_at(0)

    # -- internals ---------------------------------------------------------

    def _sleep(self, attempt: int) -> None:
        time.sleep(random.uniform(0, self.backoff * (2 ** attempt)))

    def _open_at(self, offset: int, allow_skip: bool = False) -> None:
        """Open the response at ``offset``. ``allow_skip``: if the server ignores Range
        (status 200), read and discard ``offset`` bytes instead of raising — used by the
        mid-stream recovery path, where finishing slowly beats dying."""
        if self._resp is not None:
            self._resp.close()
            self._resp = None
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                req = urllib.request.Request(self.url)
                if offset:
                    req.add_header("Range", f"bytes={offset}-")
                if self.sign is not None:
                    self.sign(req)
                resp = urllib.request.urlopen(req, timeout=self.timeout)
                if offset and resp.status != 206:
                    if allow_skip and resp.status == 200:
                        skipped = 0
                        while skipped < offset:
                            c = resp.read(min(_CHUNK, offset - skipped))
                            if not c:
                                raise ConnectionError("EOF while skipping to offset")
                            skipped += len(c)
                        self._resp = resp
                        clen = resp.headers.get("Content-Length")
                        self._end = int(clen) if clen is not None else None
                        self._pos = offset
                        self._buf = b""
                        return
                    resp.close()
                    raise IOError(
                        f"server does not support Range requests (status {resp.status})"
                    )
                self._resp = resp
                clen = resp.headers.get("Content-Length")
                self._end = offset + int(clen) if clen is not None else None
                self._pos = offset
                self._buf = b""
                return
            except Exception as e:  # noqa: BLE001 — classified below
                if isinstance(e, IOError) and "Range requests" in str(e):
                    raise  # structural, not transient
                if not _is_transient(e) or attempt == self.retries:
                    raise
                last = e
                self._sleep(attempt)
        raise IOError(f"unreachable: {last}")  # pragma: no cover

    def _read_raw(self, n: int) -> bytes:
        """One chunk from the response, re-opening at the current offset on transient
        failure mid-stream (resets self._buf — callers account for buffered bytes)."""
        for attempt in range(self.retries + 1):
            try:
                c = self._resp.read(n)
                if not c and self._end is not None and (
                    self._pos + len(self._buf) < self._end
                ):
                    # connection cut mid-body reads as a clean EOF — the advertised
                    # Content-Length says otherwise, so treat it as transient
                    raise ConnectionError(
                        f"short body: got {self._pos + len(self._buf)} of {self._end}"
                    )
                return c
            except Exception as e:  # noqa: BLE001
                if not _is_transient(e) or attempt == self.retries:
                    raise
                self._sleep(attempt)
                # re-open at the first byte we have NOT yet handed out or buffered,
                # preserving the partially-filled buffer (_open_at resets both)
                buf, pos = self._buf, self._pos
                self._open_at(pos + len(buf), allow_skip=True)
                self._buf, self._pos = buf, pos
        raise IOError("unreachable")  # pragma: no cover

    # -- io.RawIOBase ------------------------------------------------------

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = [self._buf]
            self._buf = b""
            self._pos += len(chunks[0])
            while True:
                c = self._read_raw(_CHUNK)
                if not c:
                    break
                chunks.append(c)
                self._pos += len(c)
            return b"".join(chunks)
        while len(self._buf) < n:
            c = self._read_raw(max(_CHUNK, n - len(self._buf)))
            if not c:
                break
            self._buf += c
        out, self._buf = self._buf[:n], self._buf[n:]
        self._pos += len(out)
        return out

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            offset += self._pos
        elif whence == 2:
            raise IOError("seek from end not supported over http")
        if offset != self._pos:
            self._open_at(offset)
        return self._pos

    def close(self) -> None:
        if self._resp is not None:
            self._resp.close()
            self._resp = None
        super().close()


def open_binary(path: str):
    """Open a local path, http(s) URL, or credentialed s3://|gs:// URL as a
    sequential+seekable binary stream."""
    if path.startswith(("http://", "https://")):
        return HttpStream(path)
    if path.startswith(("s3://", "gs://")):
        from denovo_kmer_tpu_torch.io.objstore import make_signer

        signed = make_signer(path)
        if signed is not None:
            url, sign = signed
            return HttpStream(url, sign=sign)
        scheme = path.split(":", 1)[0]
        need = ("AWS_ACCESS_KEY_ID + AWS_SECRET_ACCESS_KEY"
                if scheme == "s3" else "GCS_OAUTH_TOKEN")
        tool = "aws s3 presign" if scheme == "s3" else "gsutil signurl"
        raise ValueError(
            f"{scheme}:// URLs need credentials: set {need} (requests are then "
            f"signed natively, io/objstore.py), pass a presigned/public https URL "
            f"instead (e.g. `{tool}`), or download the file locally"
        )
    return open(path, "rb")
