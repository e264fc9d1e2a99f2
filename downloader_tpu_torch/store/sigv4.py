"""AWS Signature Version 4 request signing, from scratch on stdlib.

The reference gets signing from minio-go (uploader.go:41-49 selects
SignatureV4 or anonymous via the credential chain). This module implements
SigV4 directly so the rebuild's S3 client has no SDK dependency. Verified
in tests against the worked example vectors in AWS's SigV4 documentation.
"""

from __future__ import annotations

import hashlib
import hmac
import threading
import urllib.parse
from typing import Mapping

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

# the derived signing key is a pure function of (secret, date, region,
# service) and the date only changes once a day — deriving it fresh per
# request is 4 HMAC rounds of per-call fixed cost the batched fast path
# exists to shave. Tiny bound: one live credential set plus a few
# stragglers around midnight UTC.
_KEY_CACHE_MAX = 8
_key_cache_lock = threading.Lock()
_key_cache: dict[tuple[str, str, str, str], bytes] = {}  # guarded-by: _key_cache_lock


def _uri_encode(value: str, encode_slash: bool) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(value, safe=safe)


def canonical_request(
    method: str,
    path: str,
    query: Mapping[str, str],
    headers: Mapping[str, str],
    payload_hash: str,
) -> tuple[str, str]:
    """Build the canonical request; returns (canonical_request, signed_headers)."""
    canonical_query = "&".join(
        f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
        for k, v in sorted(query.items())
    )
    lower_headers = {k.lower().strip(): " ".join(v.split()) for k, v in headers.items()}
    signed_headers = ";".join(sorted(lower_headers))
    canonical_headers = "".join(
        f"{k}:{lower_headers[k]}\n" for k in sorted(lower_headers)
    )
    request = "\n".join(
        [
            method.upper(),
            _uri_encode(path, False) or "/",
            canonical_query,
            canonical_headers,
            signed_headers,
            payload_hash,
        ]
    )
    return request, signed_headers


def signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    cache_key = (secret_key, date, region, service)
    with _key_cache_lock:
        cached = _key_cache.get(cache_key)
    if cached is not None:
        return cached

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_date = _hmac(b"AWS4" + secret_key.encode(), date)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    derived = _hmac(k_service, "aws4_request")
    with _key_cache_lock:
        if len(_key_cache) >= _KEY_CACHE_MAX:
            _key_cache.clear()  # day rollover / credential churn
        _key_cache[cache_key] = derived
    return derived


def sign(
    method: str,
    path: str,
    query: Mapping[str, str],
    headers: Mapping[str, str],
    payload_hash: str,
    access_key: str,
    secret_key: str,
    region: str,
    service: str,
    amz_date: str,
) -> str:
    """Produce the Authorization header value for the request.

    ``headers`` must already include host and x-amz-date (and any x-amz-*
    headers to be signed). ``amz_date`` is ``YYYYMMDDTHHMMSSZ``.
    """
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    request, signed_headers = canonical_request(
        method, path, query, headers, payload_hash
    )
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(request.encode()).hexdigest(),
        ]
    )
    signature = hmac.new(
        signing_key(secret_key, date, region, service),
        string_to_sign.encode(),
        hashlib.sha256,
    ).hexdigest()
    return (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
