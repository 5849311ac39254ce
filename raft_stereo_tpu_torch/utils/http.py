"""Shared stdlib HTTP client, a copy of `request` and `request_json` from
`raft_stereo_tpu/utils/http.py`: one timeout discipline for the
`serve --reload_ckpt` and `frontier --rollout` clients, the front tier's
forwards and probes, the serving tests and `chip_smoke.py`'s HTTP phases.
With the two server-side helpers the serving front and the front tier
share (`json_response`, `text_response`), torch-free, so the front tier
imports no model code.

- every request carries an explicit timeout (urllib's default is NONE —
  a stalled server would hang the caller forever);
- HTTP error statuses (4xx/5xx) come back as ordinary `HttpResponse`
  objects, because for this codebase a 413/503 is a *routing signal*
  (bucket overflow, shed) the caller must inspect, not an exception;
- only TRANSPORT failures raise (`ConnectionError`/`TimeoutError`/
  `OSError` from connect, reset, or read timeout).

Stdlib-only on purpose (urllib.request over a raw http.client): the repo
adds no serving dependencies, and urllib already handles chunked replies
and connection teardown correctly.
"""

from __future__ import annotations

import json as _json
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional

DEFAULT_TIMEOUT_S = 10.0


class HttpResponse:
    """Minimal response record: status, headers, raw body + lazy .json()."""

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status = int(status)
        self.headers = dict(headers)
        self.body = body

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300

    def json(self):
        return _json.loads(self.body.decode("utf-8"))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"HttpResponse(status={self.status}, bytes={len(self.body)})"


def request(
    url: str,
    *,
    method: str = "GET",
    body: Optional[bytes] = None,
    headers: Optional[Dict[str, str]] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> HttpResponse:
    """One HTTP exchange with a mandatory timeout.

    Returns an `HttpResponse` for EVERY status the server actually sent
    (including 4xx/5xx); raises only when no response was obtained
    (connect failure, reset, read timeout) — so status handling and
    transport-failure handling can't be conflated by accident."""
    req = urllib.request.Request(
        url, data=body, headers=dict(headers or {}), method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return HttpResponse(resp.status, dict(resp.headers), resp.read())
    except urllib.error.HTTPError as exc:
        # urllib turns non-2xx into exceptions; un-turn them — the status
        # is a valid answer from a live server.
        with exc:
            return HttpResponse(exc.code, dict(exc.headers or {}), exc.read())
    except urllib.error.URLError as exc:
        reason = exc.reason
        if isinstance(reason, BaseException):
            raise reason from exc
        raise ConnectionError(str(reason)) from exc


def request_json(
    url: str,
    *,
    method: str = "GET",
    payload=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> HttpResponse:
    """JSON-body convenience over `request` (adds the content-type)."""
    body = None
    headers = {}
    if payload is not None:
        body = _json.dumps(payload).encode("utf-8")
        headers["Content-Type"] = "application/json"
    return request(
        url, method=method, body=body, headers=headers, timeout_s=timeout_s
    )


def json_response(handler: BaseHTTPRequestHandler, code: int, payload) -> None:
    """Answer a request with `payload` as JSON."""
    body = _json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def text_response(handler: BaseHTTPRequestHandler, code: int, body: str, content_type: str) -> None:
    """Answer a request with `body` as UTF-8 text of `content_type`."""
    raw = body.encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(raw)))
    handler.end_headers()
    handler.wfile.write(raw)


__all__ = [
    "DEFAULT_TIMEOUT_S",
    "HttpResponse",
    "json_response",
    "request",
    "request_json",
    "text_response",
]
