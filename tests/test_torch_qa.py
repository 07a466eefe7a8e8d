"""The port's question-answering xpack against the JAX package, on the CPU:
``BaseRAGQuestionAnswerer``, ``AdaptiveRAGQuestionAnswerer``, summaries,
``DeckRetriever``, ``rerank_topk_filter``, ``LLMReranker`` and
``CrossEncoderReranker``, the chats' ``UsageTracker`` with fake clients in
``sys.modules``, and the ``rag_evals`` report. Each pipeline is built the
same way in both packages, with ``tests/test_llm_xpack.py``'s fake chats and
fake hash embedder defined against each package's own ``BaseChat`` and
``udf``.

Tolerances: answers, contexts, reports and usage equal; cross-encoder scores
within 1e-4 (float32, the same math summed in another order)."""

from __future__ import annotations

import asyncio
import hashlib
import sys
import types

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.xpacks.llm import llms as jllms
from pathway_tpu_torch.xpacks.llm import llms as tllms

PACKAGES = pytest.mark.parametrize("pw", [jpw, tpw], ids=["jax", "torch"])
DOCS = [
    ("the quick brown fox jumps over the lazy dog", "/data/fox.txt"),
    ("pathway is a streaming dataflow framework", "/data/pathway.txt"),
    ("tpus multiply matrices with a systolic array", "/data/tpu.txt"),
    ("kafka consumer groups rebalance partitions", "/data/kafka.txt"),
    ("sourdough rises as wild yeast ferments the dough", "/data/bread.txt"),
]


def _fakes(pw):
    """The fake chats and embedder of ``tests/mocks.py``, for one package."""
    llms = pw.xpacks.llm.llms

    class FakeChatModel(llms.BaseChat):
        def __wrapped__(self, messages, **kwargs) -> str:
            return "Text"

        def _accepts_call_arg(self, arg_name: str) -> bool:
            return True

    class IdentityMockChat(llms.BaseChat):
        def __wrapped__(self, messages, model: str = "mock", **kwargs) -> str:
            plain = llms._messages_to_plain(messages)
            return f"{model}: {plain[-1]['content'] if plain else ''}"

        def _accepts_call_arg(self, arg_name: str) -> bool:
            return True

    class GrowingContextChat(FakeChatModel):
        """Refuses until the context holds at least three documents."""

        def __wrapped__(self, messages, **kwargs):
            content = llms._messages_to_plain(messages)[-1]["content"]
            return "An actual answer" if content.count("\n") > 8 else "No information found."

    @pw.udf
    def fake_embeddings_model(x: str) -> np.ndarray:
        h = hashlib.sha256((x or "").encode()).digest()
        v = np.frombuffer(h[:32], dtype=np.uint32).astype(np.float32)
        return v / np.linalg.norm(v)

    return types.SimpleNamespace(fake=FakeChatModel, identity=IdentityMockChat, growing=GrowingContextChat,
                                 embed=fake_embeddings_model)


def _docs_table(pw):
    class DocSchema(pw.Schema):
        data: bytes
        _metadata: pw.Json

    rows = [(text.encode(), pw.Json({"path": path, "modified_at": 1700000000 + i, "seen_at": 1700000100 + i}))
            for i, (text, path) in enumerate(DOCS)]
    return pw.debug.table_from_rows(DocSchema, rows)


def _plain(v):
    return _plain(v.value) if hasattr(v, "value") and type(v).__name__ == "Json" else (
        {k: _plain(x) for k, x in v.items()} if isinstance(v, dict) else
        [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v)


def _results(pw, table):
    _, columns = pw.debug.table_to_dicts(table)
    (col,) = columns.values()
    return sorted((_plain(v) for v in col.values()), key=repr)


def _answer(pw, make_rag, questions, **schema_defaults):
    pw.clear_graph()
    rag = make_rag(pw, _fakes(pw))

    class QSchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)
        model: str | None = pw.column_definition(default_value=None)
        return_context_docs: bool | None = pw.column_definition(default_value=True)

    q = pw.debug.table_from_rows(QSchema, [(p, None, None, True) for p in questions])
    out = _results(pw, rag.answer_query(q))
    pw.clear_graph()
    return out


def _knn(pw, embed):
    """The brute-force KNN factory over ``embed``; the port's index is asked
    for the CPU (a plain UDF embedder names no device)."""
    kw = {"device": "cpu"} if pw is tpw else {}
    return pw.stdlib.indexing.BruteForceKnnFactory(embedder=embed, **kw)


def _vector_store(pw, f):
    return pw.xpacks.llm.VectorStoreServer(_docs_table(pw), embedder=f.embed, index_factory=_knn(pw, f.embed))


def _base_rag(pw, f):
    store = _vector_store(pw, f)
    return pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer(f.identity(), store, search_topk=3)


def _adaptive_rag(pw, f):
    store = _vector_store(pw, f)
    return pw.xpacks.llm.question_answering.AdaptiveRAGQuestionAnswerer(
        f.growing(), store, n_starting_documents=1, factor=2, max_iterations=3)


def _document_store_rag(pw, f):
    store = pw.xpacks.llm.DocumentStore(_docs_table(pw), retriever_factory=_knn(pw, f.embed))
    return pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer(f.fake(), store, search_topk=2)


QUESTIONS = ["pathway is a streaming dataflow framework", "what rises overnight?", "kafka partitions"]


@pytest.mark.parametrize("make_rag", [_base_rag, _adaptive_rag, _document_store_rag],
                         ids=["base", "adaptive", "document_store"])
def test_rag_answers_and_contexts_equal_the_reference(make_rag):
    got = _answer(tpw, make_rag, QUESTIONS)
    want = _answer(jpw, make_rag, QUESTIONS)
    assert got == want and len(got) == len(QUESTIONS)
    if make_rag is _base_rag:
        assert all(r["context_docs"] and r["response"].startswith("mock: ") for r in got)


def _summaries(pw):
    pw.clear_graph()
    f = _fakes(pw)
    rag = pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer(f.identity(), _vector_store(pw, f))

    class SSchema(pw.Schema):
        text_list: list
        model: str | None = pw.column_definition(default_value=None)

    q = pw.debug.table_from_rows(SSchema, [(("a", "b"), None), (("pathway", "streams", "tables"), "m2")])
    out = _results(pw, rag.summarize_query(q))
    pw.clear_graph()
    return out


def test_summaries_equal_the_reference():
    got = _summaries(tpw)
    assert got == _summaries(jpw) and all(s.startswith("mock: ") for s in got)


def _deck(pw):
    pw.clear_graph()
    deck = pw.xpacks.llm.question_answering.DeckRetriever(_vector_store(pw, _fakes(pw)), search_topk=2)

    class QSchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)

    out = _results(pw, deck.answer_query(pw.debug.table_from_rows(QSchema, [(q, None) for q in QUESTIONS])))
    pw.clear_graph()
    return out


def test_deck_retriever_equals_the_reference():
    assert _deck(tpw) == _deck(jpw)


@PACKAGES
def test_geometric_strategy_and_rerank_filter(pw):
    qa, rr = pw.xpacks.llm.question_answering, pw.xpacks.llm.rerankers
    chat = _fakes(pw).growing()
    docs = [[f"doc {i}" for i in range(8)], ["only one"]]
    answers = qa.answer_with_geometric_rag_strategy(["q1", "q2"], docs, chat, 1, 2, 4)
    assert answers == ["An actual answer", "No information found."]
    top, scores = rr.rerank_topk_filter.func([{"text": "a"}, {"text": "b"}, {"text": "c"}], [1.0, 3.0, 2.0], 2)
    assert [d["text"] for d in top] == ["b", "c"] and scores == [3.0, 2.0]
    assert rr.rerank_topk_filter.func([], [], 3) == ([], [])


@PACKAGES
def test_llm_reranker(pw):
    base = _fakes(pw).fake
    llms = pw.xpacks.llm.llms

    class ScoreChat(base):
        def __wrapped__(self, messages, **kwargs):
            return "4" if "relevant-doc" in llms._messages_to_plain(messages)[-1]["content"] else "1"

    rr = pw.xpacks.llm.rerankers.LLMReranker(ScoreChat())
    assert (rr.__wrapped__("relevant-doc", "query"), rr.__wrapped__("other", "query")) == (4.0, 1.0)
    assert rr.use_logit_bias is True and rr.number_biases == {str(t): 50 for t in range(16, 21)}
    with pytest.raises(ValueError, match="unparsable"):
        rr.get_first_number("none")


TINY_XENC = dict(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=128)


def test_cross_encoder_reranker_scores_and_top_k_equal_the_reference():
    """Both rerankers score the same (doc, query) rows in a pipeline with
    the reference's weights bridged, then keep the top 2 per query."""
    import jax.numpy as jnp
    import torch

    from pathway_tpu.models.encoder import EncoderConfig as JCfg
    from pathway_tpu.models.tokenizer import WordPieceTokenizer as JTok
    from pathway_tpu_torch.models.encoder import EncoderConfig as TCfg
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
    from pathway_tpu_torch.weights import from_jax_cross_encoder_params

    jr = jpw.xpacks.llm.rerankers.CrossEncoderReranker(config=JCfg.cross_encoder_l6(**TINY_XENC, dtype=jnp.float32),
                                                       checkpoint_dir="/nonexistent", max_seq_len=64, max_batch=8)
    jr._scorer.tokenizer = JTok(vocab_size=TINY_XENC["vocab_size"])
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jr._scorer.params))
    tr = tpw.xpacks.llm.rerankers.CrossEncoderReranker(config=TCfg.cross_encoder_l6(**TINY_XENC, dtype=torch.float32),
                                                       max_seq_len=64, max_batch=8, device="cpu",
                                                       params=from_jax_cross_encoder_params(tree))
    tr._scorer.tokenizer = TTok(vocab_size=TINY_XENC["vocab_size"])

    def run(pw, rr):
        pw.clear_graph()

        class S(pw.Schema):
            query: str
            doc: str

        rows = [(q, d) for q in ("streaming dataflow", "wild yeast") for d, _ in DOCS]
        t = pw.debug.table_from_rows(S, rows)
        scored = t.select(pw.this.query, pw.this.doc, score=rr(pw.this.doc, pw.this.query))
        _, cols = pw.debug.table_to_dicts(scored)
        out = sorted((cols["query"][k], cols["doc"][k], float(cols["score"][k])) for k in cols["query"])
        pw.clear_graph()
        return out

    got, want = run(tpw, tr), run(jpw, jr)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=1e-4, atol=1e-4)
    for q in ("streaming dataflow", "wild yeast"):
        docs = [{"text": d} for qq, d, _ in got if qq == q]
        top_t = tpw.xpacks.llm.rerankers.rerank_topk_filter.func(docs, [s for qq, _, s in got if qq == q], 2)
        top_j = jpw.xpacks.llm.rerankers.rerank_topk_filter.func(docs, [s for qq, _, s in want if qq == q], 2)
        assert top_t[0] == top_j[0]


# --------------------------------------------------------- chats and usage


class _Resp:
    def __init__(self, text, prompt_toks, completion_toks):
        self.choices = [types.SimpleNamespace(message=types.SimpleNamespace(content=text))]
        self.usage = types.SimpleNamespace(prompt_tokens=prompt_toks, completion_tokens=completion_toks)


@pytest.fixture
def fake_clients(monkeypatch):
    calls = []

    class _Completions:
        async def create(self, messages, **kwargs):
            calls.append({"messages": messages, **kwargs})
            if kwargs.get("model") == "broken-model":
                raise RuntimeError("upstream 500")
            return _Resp("hello there", 12, 5)

    class _Client:
        def __init__(self, api_key=None, base_url=None):
            calls.append({"_client": {"api_key": api_key, "base_url": base_url}})
            self.chat = types.SimpleNamespace(completions=_Completions())

    openai = types.ModuleType("openai")
    openai.AsyncOpenAI = _Client

    async def acompletion(messages, **kwargs):
        calls.append({"litellm": kwargs.get("model")})
        return types.SimpleNamespace(choices=[{"message": {"content": "ok"}}],
                                     usage=types.SimpleNamespace(prompt_tokens=3, completion_tokens=4))

    litellm = types.ModuleType("litellm")
    litellm.acompletion = acompletion

    class _Cohere:
        def chat(self, chat_history, message, documents=None, **kwargs):
            calls.append({"cohere": (chat_history, message, documents, kwargs)})
            return types.SimpleNamespace(text=f"re: {message}", citations=[{"start": 0, "end": 2}])

    cohere = types.ModuleType("cohere")
    cohere.Client = _Cohere
    for name, mod in (("openai", openai), ("litellm", litellm), ("cohere", cohere)):
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


def _chat_script(llms):
    tracker = llms.UsageTracker()
    msgs = [{"role": "user", "content": "hi"}]
    a = llms.OpenAIChat(model="gpt-4o", temperature=0.2, seed=7, api_key="sk-test", usage_tracker=tracker)
    b = llms.OpenAIChat(model="broken-model", usage_tracker=tracker)
    c = llms.LiteLLMChat(model="claude-x", usage_tracker=tracker)
    out = [asyncio.run(a.__wrapped__(msgs)), asyncio.run(a.__wrapped__(msgs, temperature=0.9))]
    with pytest.raises(RuntimeError, match="upstream 500"):
        asyncio.run(b.__wrapped__(msgs))
    out.append(asyncio.run(c.__wrapped__(msgs)))
    out.append(llms.CohereChat(model="command").__wrapped__(
        [{"role": "system", "content": "be brief"}, {"role": "user", "content": "q"}], docs=[{"t": 1}]))
    out += [tracker.as_dict(), tracker.cost_estimate({"gpt-4o": (1.0, 2.0), "claude-x": (0.5, 0.5)}),
            a._accepts_call_arg("temperature"), a._accepts_call_arg("logit_bias"), a.model]
    return out


def test_chats_and_usage_tracker_equal_the_reference(fake_clients):
    got = _chat_script(tllms)
    n = len(fake_clients)
    assert got == _chat_script(jllms)
    assert fake_clients[:n] == fake_clients[n:]  # the same provider calls, in the same order
    assert got[-5]["gpt-4o"] == {"requests": 2, "failures": 0, "prompt_tokens": 24, "completion_tokens": 10,
                                 "total_tokens": 34}


def test_service_clients_are_imported_only_when_called(monkeypatch):
    """No client package is imported with the modules; each is imported
    when a chat is called (or, for ``HFPipelineChat`` and
    ``FlashRankReranker``, built). ``transformers`` and ``flashrank`` are
    replaced by fakes here, so nothing is downloaded."""
    for name in ("openai", "litellm", "cohere", "flashrank"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    chat = tllms.OpenAIChat(model="gpt-4o")  # builds without the client package
    monkeypatch.setitem(sys.modules, "openai", None)  # importing it now fails
    with pytest.raises(ImportError, match="openai"):
        asyncio.run(chat.__wrapped__([{"role": "user", "content": "hi"}]))
    built = []

    class _Tok:
        chat_template = None

        def tokenize(self, text):
            return text.split()

        def convert_tokens_to_string(self, toks):
            return " ".join(toks)

    class _Pipe:
        def __init__(self, task, model=None, device=None, **kw):
            built.append((task, model, device, kw))
            self.tokenizer = _Tok()

        def __call__(self, prompt, **call):
            return [{"generated_text": f"{prompt} +{call.get('max_new_tokens', 0)}"}]

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(pipeline=_Pipe))
    hf = tllms.HFPipelineChat(model="tiny", call_kwargs={"max_new_tokens": 3}, device="cpu")
    assert built == [("text-generation", "tiny", torch.device("cpu"), {})]
    assert hf.__wrapped__([{"role": "user", "content": "a b"}]) == "a b +3"
    assert hf.crop_to_max_length("w " * 10, max_prompt_length=4) == "w w w w"

    class _Ranker:
        def __init__(self, model_name, max_length):
            built.append((model_name, max_length))

        def rerank(self, req):
            return [{"score": len(req.passages[0]["text"]) / 10.0}]

    monkeypatch.setitem(sys.modules, "flashrank", types.SimpleNamespace(
        Ranker=_Ranker, RerankRequest=lambda query, passages: types.SimpleNamespace(query=query, passages=passages)))
    fr = tpw.xpacks.llm.rerankers.FlashRankReranker()
    assert built[-1] == ("ms-marco-TinyBERT-L-2-v2", 512) and fr.__wrapped__("abcd", "q") == 0.4


@PACKAGES
def test_prompt_chat_single_qa_and_chat_calls_record_the_endpoint(pw):
    assert pw.xpacks.llm.llms.prompt_chat_single_qa.func("why?").value == [{"role": "user", "content": "why?"}]
    pw.clear_graph()
    t = pw.debug.table_from_markdown("""
      | q
    1 | hi
    """)
    t.select(a=_fakes(pw).fake()(pw.xpacks.llm.llms.prompt_chat_single_qa(pw.this.q)))
    assert pw.internals.parse_graph.G.llm_endpoints == [{"kind": "llm_chat", "model": None}]
    pw.clear_graph()


# --------------------------------------------------------------- rag evals


def _eval_report(pw):
    pw.clear_graph()
    rag_evals = pw.xpacks.llm.rag_evals
    f = _fakes(pw)
    store = pw.xpacks.llm.DocumentStore(_docs_table(pw), retriever_factory=_knn(pw, f.embed))
    cases = [rag_evals.EvalCase(text, path, tuple(text.split()[:2])) for text, path in DOCS]
    cases.append(rag_evals.EvalCase("something else entirely", "/data/none.txt", ("absent",)))
    report = rag_evals.evaluate_document_store(store, cases, k=2)
    pw.clear_graph()
    return report.as_dict(), [(o.retrieved_files, o.rank, o.answer, o.term_coverage) for o in report.outcomes]


def test_rag_evals_report_equals_the_reference():
    got, want = _eval_report(tpw), _eval_report(jpw)
    assert got == want
    assert got[0]["hit_rate"] == round(5 / 6, 4) and got[0]["misses"] == ["something else entirely"]
    assert tpw.xpacks.llm.rag_evals.extractive_answerer("q", ["a", "b"]) == "a\nb"
