"""Shared HTTP plumbing for the xpack clients (VectorStoreClient, and
RAGClient when it is ported): the port's copy of the reference's
``xpacks/llm/_http.py``, one url-derivation rule and one
standard-library JSON POST."""

from __future__ import annotations

import json


def derive_url(host: str | None, port: int | None, url: str | None) -> str:
    """Exactly one of (host[, port]) or url; port 443 implies https."""
    err = "specify either host and port or url, not both"
    if url is not None:
        if host is not None or port is not None:
            raise ValueError(err)
        return url
    if host is None:
        raise ValueError(err)
    port = port or 80
    protocol = "https" if port == 443 else "http"
    return f"{protocol}://{host}:{port}"


def post_json(
    url: str,
    data: dict,
    headers: dict | None = None,
    timeout: float | None = None,
):
    """POST json, raise on HTTP errors, return the decoded body."""
    import urllib.request

    req = urllib.request.Request(
        url,
        data=json.dumps(data).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())
