"""HTTP transport for the vendor API clients (a copy of the JAX package's
``api_backends/transport.py``).

No vendor SDK is needed: the clients speak HTTP through this thin stdlib
``urllib`` transport.  The transport is injectable, so tests and
``chip_smoke.py`` drive every client through :class:`FakeTransport` and
never open a socket; only a deployment with real keys does.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
import uuid
from typing import Dict, Optional, Tuple


class TransportError(Exception):
    def __init__(self, status: int, body: str, retryable: bool):
        super().__init__(f"HTTP {status}: {body[:200]}")
        self.status = status
        self.body = body
        self.retryable = retryable


RETRYABLE_STATUS = {408, 409, 425, 429, 500, 502, 503, 504, 529}


class UrllibTransport:
    def __init__(self, timeout: float = 120.0):
        self.timeout = timeout

    def request(
        self,
        method: str,
        url: str,
        headers: Optional[Dict[str, str]] = None,
        json_body=None,
        data: Optional[bytes] = None,
    ) -> Tuple[int, bytes]:
        body = data
        headers = dict(headers or {})
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers.setdefault("Content-Type", "application/json")
        req = urllib.request.Request(url, data=body, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            raise TransportError(
                err.code, err.read().decode(errors="replace"),
                retryable=err.code in RETRYABLE_STATUS,
            ) from err
        except urllib.error.URLError as err:
            raise TransportError(0, str(err.reason), retryable=True) from err


def multipart_form(fields: Dict[str, str], files: Dict[str, Tuple[str, bytes]]):
    """(content_type, body) for multipart/form-data uploads (batch JSONL)."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n{value}\r\n".encode()
        )
    for name, (filename, content) in files.items():
        parts.append(
            (
                f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream\r\n\r\n"
            ).encode()
            + content
            + b"\r\n"
        )
    parts.append(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


class FakeTransport:
    """Programmable transport for tests: queue of (matcher, responder)."""

    def __init__(self):
        self.calls = []
        self.handlers = []

    def add(self, method: str, url_substr: str, responder):
        """responder(call) -> (status, body_dict_or_bytes); errors may raise."""
        self.handlers.append((method, url_substr, responder))

    def request(self, method, url, headers=None, json_body=None, data=None):
        call = {
            "method": method,
            "url": url,
            "headers": headers or {},
            "json": json_body,
            "data": data,
        }
        self.calls.append(call)
        for m, sub, responder in self.handlers:
            if m == method and sub in url:
                status, body = responder(call)
                if isinstance(body, (dict, list)):
                    body = json.dumps(body).encode()
                return status, body
        raise TransportError(404, f"no fake handler for {method} {url}", retryable=False)
