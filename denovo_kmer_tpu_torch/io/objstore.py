"""Authenticated object-store access for s3:// and gs:// BAM/CRAM URLs.

The reference links libcurl through HTSlib (`ci.yml:26`), which gives it credentialed
S3/GCS object reads (hfile_s3 / hfile_gcs). This is the stdlib-only counterpart:

- ``s3://bucket/key`` → virtual-hosted-style https URL + AWS Signature Version 4
  request signing (pure hmac/sha256, no SDK), credentials from the standard env vars
  ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` (+ optional ``AWS_SESSION_TOKEN``,
  ``AWS_DEFAULT_REGION``, ``AWS_ENDPOINT_URL`` for S3-compatible stores → path-style).
  Every request is re-signed (Range re-opens change the signed headers), matching
  hfile_s3's per-request signing.
- ``gs://bucket/obj`` → ``https://storage.googleapis.com/bucket/obj`` with a Bearer
  token from ``GCS_OAUTH_TOKEN`` — the SAME env var HTSlib's hfile_gcs reads.

Signing is validated against the published AWS SigV4 example vector (the
"GET /test.txt, Range: bytes=0-9, 20130524T000000Z" example of the S3 API reference)
in tests/test_objstore.py — signing needs no network to verify. Without credentials
both schemes keep the round-2 behavior: an actionable presigned-URL error.

The port's copy of ``denovo_kmer_tpu/io/objstore.py``; its imports point at the port.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, encode_slash: bool) -> str:
    """AWS canonical URI encoding: RFC 3986 unreserved chars stay, space -> %20."""
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def sigv4_headers(
    method: str,
    url: str,
    region: str,
    access_key: str,
    secret_key: str,
    session_token: Optional[str] = None,
    extra_headers: Optional[Dict[str, str]] = None,
    amzdate: Optional[str] = None,
    service: str = "s3",
    payload_sha256: str = _EMPTY_SHA256,
) -> Dict[str, str]:
    """Headers (including Authorization) for one AWS SigV4-signed request.

    ``amzdate`` (YYYYMMDD'T'HHMMSS'Z') is injectable for the test vectors; production
    callers omit it and get the current UTC time.
    """
    parts = urllib.parse.urlsplit(url)
    host = parts.netloc
    if amzdate is None:
        amzdate = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ"
        )
    datestamp = amzdate[:8]

    headers: Dict[str, str] = {
        "host": host,
        "x-amz-content-sha256": payload_sha256,
        "x-amz-date": amzdate,
    }
    if session_token:
        headers["x-amz-security-token"] = session_token
    for k, v in (extra_headers or {}).items():
        headers[k.lower()] = v.strip()

    canonical_uri = _uri_encode(parts.path or "/", encode_slash=False)
    # canonical query: sorted by key, strict URI-encoding of keys and values
    q = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
        for k, v in sorted(q)
    )
    signed_names = sorted(headers)
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_request = "\n".join([
        method,
        canonical_uri,
        canonical_query,
        canonical_headers,
        signed_headers,
        payload_sha256,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256",
        amzdate,
        scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    out = dict(headers)
    out.pop("host")  # urllib sets Host itself; signing included it
    return out


def s3_url(path: str, region: str, endpoint: Optional[str] = None) -> str:
    """s3://bucket/key → https URL (virtual-hosted style; path-style on a custom
    endpoint, the S3-compatible-store convention)."""
    rest = path[len("s3://"):]
    bucket, _, key = rest.partition("/")
    if not bucket or not key:
        raise ValueError(f"malformed s3 URL: {path}")
    key_enc = _uri_encode(key, encode_slash=False)
    if endpoint:
        return f"{endpoint.rstrip('/')}/{bucket}/{key_enc}"
    host = (
        f"{bucket}.s3.amazonaws.com" if region == "us-east-1"
        else f"{bucket}.s3.{region}.amazonaws.com"
    )
    return f"https://{host}/{key_enc}"


def gs_url(path: str) -> str:
    rest = path[len("gs://"):]
    bucket, _, obj = rest.partition("/")
    if not bucket or not obj:
        raise ValueError(f"malformed gs URL: {path}")
    return f"https://storage.googleapis.com/{bucket}/{_uri_encode(obj, False)}"


def make_signer(path: str) -> Optional[Tuple[str, object]]:
    """(https_url, sign_fn) for an s3:// or gs:// path using env credentials, or None
    when the needed credentials are absent (caller falls back to the guidance error).
    ``sign_fn(request)`` mutates a urllib Request in place; it is called per request,
    AFTER all other headers (e.g. Range) are set, so re-opens re-sign correctly."""
    if path.startswith("s3://"):
        access = os.environ.get("AWS_ACCESS_KEY_ID")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
        if not access or not secret:
            return None
        region = os.environ.get("AWS_DEFAULT_REGION", "us-east-1")
        token = os.environ.get("AWS_SESSION_TOKEN")
        url = s3_url(path, region, os.environ.get("AWS_ENDPOINT_URL"))

        def sign(req: urllib.request.Request) -> None:
            extra = {k: v for k, v in req.header_items()}
            hdrs = sigv4_headers(
                req.get_method(), req.full_url, region, access, secret,
                session_token=token, extra_headers=extra,
            )
            for k, v in hdrs.items():
                req.add_header(k.capitalize() if k != "x-amz-date" else k, v)

        return url, sign
    if path.startswith("gs://"):
        token = os.environ.get("GCS_OAUTH_TOKEN")  # htslib hfile_gcs convention
        if not token:
            return None
        url = gs_url(path)

        def sign(req: urllib.request.Request) -> None:
            req.add_header("Authorization", f"Bearer {token}")

        return url, sign
    return None
