"""The port's HTTP embedders held against the JAX package's, on the CPU.

``OpenAIEmbedder``, ``LiteLLMEmbedder`` and ``GeminiEmbedder`` of both
packages run against fake ``openai``, ``litellm`` and
``google.generativeai`` modules put in ``sys.modules``, as
``tests/test_llms_usage.py`` fakes its clients. Each fake records the calls
it gets and answers with a vector derived from the input text. Both
packages must make the same calls and return equal arrays: called
directly, through ``get_embedding_dimension``, and as a UDF in a run with a
retry strategy and a cache. Without the client package each raises the
same ``ImportError``.
"""

from __future__ import annotations

import asyncio
import importlib
import sys
import types
import zlib

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

PACKAGES = {"reference": jpw, "port": tpw}
DIM = 6


def _vector(text: str) -> list[float]:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    return rng.standard_normal(DIM).round(6).tolist()


@pytest.fixture(params=sorted(PACKAGES))
def pw(request):
    pkg = PACKAGES[request.param]
    jpw.clear_graph()
    tpw.clear_graph()
    yield pkg
    jpw.clear_graph()
    tpw.clear_graph()


@pytest.fixture
def clients(monkeypatch):
    """Fake ``openai``, ``litellm`` and ``google.generativeai``: each call
    recorded as (client, keyword arguments); ``fail`` lists texts whose
    first request raises."""
    calls: list = []
    fail: set = set()

    def answer(texts):
        for t in texts:
            if t in fail:
                fail.discard(t)
                raise ConnectionError(f"transient failure for {t!r}")
        return [_vector(t) for t in texts]

    class _Embeddings:
        async def create(self, input, **kwargs):
            calls.append(("openai.create", {"input": list(input), **kwargs}))
            data = [types.SimpleNamespace(embedding=v) for v in answer(input)]
            return types.SimpleNamespace(data=data)

    class AsyncOpenAI:
        def __init__(self, api_key=None, base_url=None):
            calls.append(("openai.client", {"api_key": api_key, "base_url": base_url}))
            self.embeddings = _Embeddings()

    openai = types.ModuleType("openai")
    openai.AsyncOpenAI = AsyncOpenAI

    async def aembedding(input, **kwargs):
        calls.append(("litellm.aembedding", {"input": list(input), **kwargs}))
        return types.SimpleNamespace(data=[{"embedding": v} for v in answer(input)])

    litellm = types.ModuleType("litellm")
    litellm.aembedding = aembedding

    def embed_content(content, **kwargs):
        calls.append(("genai.embed_content", {"content": list(content), **kwargs}))
        return {"embedding": answer(content)}

    genai = types.ModuleType("google.generativeai")
    genai.embed_content = embed_content
    google = types.ModuleType("google")
    google.generativeai = genai
    for name, mod in (("openai", openai), ("litellm", litellm), ("google", google), ("google.generativeai", genai)):
        monkeypatch.setitem(sys.modules, name, mod)
    return types.SimpleNamespace(calls=calls, fail=fail)


def _embedders(pw):
    return importlib.import_module(f"{pw.__name__}.xpacks.llm.embedders")


def _make(pw, kind: str, **kw):
    e = _embedders(pw)
    if kind == "openai":
        return e.OpenAIEmbedder(model="text-embedding-3-small", api_key="sk-test", base_url="http://proxy",
                                dimensions=DIM, **kw)
    if kind == "litellm":
        return e.LiteLLMEmbedder(model="ollama/nomic", api_base="http://ollama:11434", **kw)
    return e.GeminiEmbedder(task_type="retrieval_document", **kw)


def _call(embedder, text, **kwargs):
    out = embedder.__wrapped__(text, **kwargs)
    return asyncio.run(out) if asyncio.iscoroutine(out) else out


def _both(pw, clients, scenario):
    """``scenario(pw)`` -> (result, calls); on the port also on the
    reference, whose result and calls must be equal."""
    got = (scenario(pw), list(clients.calls))
    if pw is tpw:
        clients.calls.clear()
        want = (scenario(jpw), list(clients.calls))
        assert _plain(got) == _plain(want)
    return got


def _plain(value):
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.tolist())
    if isinstance(value, (list, tuple)):
        return type(value).__name__, [_plain(v) for v in value]
    if isinstance(value, dict):
        return sorted((k, _plain(v)) for k, v in value.items())
    return value


@pytest.mark.parametrize("kind", ["openai", "litellm", "gemini"])
def test_embedder_call_reaches_the_client(pw, clients, kind):
    def scenario(pw):
        emb = _make(pw, kind)
        return [_call(emb, "river stone"), _call(emb, ""), _call(emb, "cloud", user="u1")]

    (vecs, calls) = _both(pw, clients, scenario)
    assert [type(v) for v in vecs] == [np.ndarray] * 3
    np.testing.assert_array_equal(vecs[0], np.array(_vector("river stone")))
    np.testing.assert_array_equal(vecs[1], np.array(_vector(".")))  # empty input sends "."
    request = {
        "openai": ("openai.create", {"input": ["river stone"], "model": "text-embedding-3-small", "dimensions": DIM}),
        "litellm": ("litellm.aembedding", {"input": ["river stone"], "model": "ollama/nomic",
                                           "api_base": "http://ollama:11434"}),
        "gemini": ("genai.embed_content", {"content": ["river stone"], "model": "models/embedding-001",
                                           "task_type": "retrieval_document"}),
    }[kind]
    requests = [c for c in calls if not c[0].endswith("client")]
    assert requests[0] == request and requests[2][1]["user"] == "u1" and len(requests) == 3
    if kind == "openai":
        assert ("openai.client", {"api_key": "sk-test", "base_url": "http://proxy"}) in calls
        assert all("api_key" not in c[1] for c in requests)


@pytest.mark.parametrize("kind", ["openai", "litellm", "gemini"])
def test_embedder_dimension(pw, clients, kind):
    dim, _calls = _both(pw, clients, lambda pw: _make(pw, kind).get_embedding_dimension())
    assert dim == DIM


@pytest.mark.parametrize("kind", ["openai", "litellm", "gemini"])
def test_embedder_as_a_udf_with_retries_and_a_cache(pw, clients, kind):
    """In a run: the first request for "b" fails once and the retry
    strategy sends it again; the cache answers a repeated text without a
    request."""

    def scenario(pw):
        clients.fail.add("b")
        udfs = importlib.import_module(f"{pw.__name__}.internals.udfs")
        emb = _make(pw, kind, retry_strategy=udfs.FixedDelayRetryStrategy(max_retries=2, delay_ms=1),
                    cache_strategy=udfs.InMemoryCache())
        t = pw.debug.table_from_markdown("""
            n | text
            1 | a
            2 | b
            3 | a
        """)
        out = t.select(pw.this.n, vec=emb(pw.this.text))
        rows = []
        pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: rows.append((row["n"], row["vec"])))
        pw.run(monitoring_level="none")
        pw.clear_graph()
        return sorted(rows, key=lambda r: r[0])

    rows, calls = _both(pw, clients, scenario)
    assert [i for i, _v in rows] == [1, 2, 3]
    for (i, vec), text in zip(rows, "aba"):
        np.testing.assert_array_equal(vec, np.array(_vector(text)))
    sent = [c[1].get("input", c[1].get("content")) for c in calls if not c[0].endswith("client")]
    assert sorted(map(tuple, sent)) == [("a",), ("b",), ("b",)]


@pytest.mark.parametrize("kind,module,message", [
    ("openai", "openai", "requires the openai package"),
    ("litellm", "litellm", "requires the litellm package"),
    ("gemini", "google.generativeai", "requires google-generativeai"),
])
def test_embedder_without_its_client_raises(pw, monkeypatch, kind, module, message):
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=message):
        _call(_make(pw, kind), "x")
