"""LLM chat-model UDFs.

The port's copy of the reference's ``xpacks/llm/llms.py`` (upstream
Pathway's xpacks/llm/llms.py: BaseChat :27, OpenAIChat :84, LiteLLMChat
:313, HFPipelineChat :441, CohereChat :544, prompt_chat_single_qa :686).
The network-backed chats are thin async wrappers whose client packages
(``openai``, ``litellm``, ``cohere``) are imported when a chat is called,
never when this module is imported; ``HFPipelineChat`` imports
``transformers`` when it is built.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
from abc import abstractmethod
from dataclasses import dataclass, field
from typing import Any

from ...device import resolve_device
from ...engine.value import Json
from ...internals import udfs
from ...internals.expression import ColumnExpression
from ._utils import _check_model_accepts_arg

logger = logging.getLogger(__name__)


def _prep_message_log(messages: list[dict], verbose: bool) -> str:
    if verbose:
        return json.dumps(messages, ensure_ascii=False, default=str)[:5000]
    return "..."


@dataclass
class ModelUsage:
    """Accumulated accounting for one model id."""

    requests: int = 0
    failures: int = 0
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


@dataclass
class UsageTracker:
    """Per-model request/token accounting for chat and embedder UDFs.

    Every provider call records its reported ``usage`` block here (the
    reference logs request/response events but keeps no running
    totals — reference llms.py:268-287).  Thread-safe: async executors
    fan calls out concurrently.
    """

    per_model: dict[str, ModelUsage] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _ids: Any = field(default_factory=lambda: itertools.count(1), repr=False)

    def next_request_id(self) -> str:
        return f"req-{next(self._ids)}"

    def record(self, model: str | None, usage: Any = None, failed: bool = False):
        """``usage`` accepts an OpenAI-shaped object or dict with
        prompt_tokens / completion_tokens (extra keys ignored)."""
        name = model or "<unknown>"
        get = (
            usage.get
            if isinstance(usage, dict)
            else lambda k, d=0: getattr(usage, k, d) or d
        )
        with self._lock:
            entry = self.per_model.setdefault(name, ModelUsage())
            entry.requests += 1
            if failed:
                entry.failures += 1
            elif usage is not None:
                entry.prompt_tokens += int(get("prompt_tokens", 0) or 0)
                entry.completion_tokens += int(get("completion_tokens", 0) or 0)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                m: {
                    "requests": u.requests,
                    "failures": u.failures,
                    "prompt_tokens": u.prompt_tokens,
                    "completion_tokens": u.completion_tokens,
                    "total_tokens": u.total_tokens,
                }
                for m, u in self.per_model.items()
            }

    def cost_estimate(self, prices_per_1k: dict[str, tuple[float, float]]) -> float:
        """USD estimate given {model: ($/1k prompt, $/1k completion)}."""
        total = 0.0
        with self._lock:
            for m, u in self.per_model.items():
                if m in prices_per_1k:
                    pin, pout = prices_per_1k[m]
                    total += u.prompt_tokens / 1000.0 * pin
                    total += u.completion_tokens / 1000.0 * pout
        return total


def _messages_to_plain(messages) -> list[dict]:
    if isinstance(messages, Json):
        messages = messages.value
    out = []
    for m in messages or []:
        if isinstance(m, Json):
            m = m.value
        out.append(dict(m))
    return out


class BaseChat(udfs.UDF):
    """Base class for chat models: ``__wrapped__(messages) -> str``.

    ``messages`` is a list of {"role": ..., "content": ...} dicts
    (possibly wrapped in Json).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kwargs: dict[str, Any] = getattr(self, "kwargs", {})

    @abstractmethod
    def _accepts_call_arg(self, arg_name: str) -> bool:
        """Whether the underlying provider/model accepts `arg_name` as a
        per-call parameter (reference llms.py:48)."""

    @property
    def model(self) -> str | None:
        return self.kwargs.get("model")

    def __call__(self, messages: ColumnExpression, **kwargs) -> ColumnExpression:
        # the graph's record of its HTTP LLM stages (the deep verifier's
        # PWL013 reads it, ROADMAP Queue A item 10)
        from ...internals.parse_graph import G

        G.llm_endpoints.append({"kind": "llm_chat", "model": self.model})
        return super().__call__(messages, **kwargs)


class OpenAIChat(BaseChat):
    """OpenAI chat.completions wrapper (reference llms.py:84).

    ``capacity``/``retry_strategy``/``cache_strategy`` wire the UDF
    executor (concurrency bound, backoff retries, persistent response
    cache) and are fixed at construction. ``retry_strategy`` accepts
    a ``udfs.AsyncRetryStrategy`` (the shared ``RetryPolicy`` comes with
    ROADMAP Queue A item 1); every sampling/decoding
    option below (and any extra provider kwarg) sets a default that a
    per-call kwarg overrides.  Each request/response pair is logged as
    a structured event under a shared correlation id, and the reported
    token usage accumulates on :attr:`usage` (a :class:`UsageTracker`,
    shareable between chats to account a whole app)."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "gpt-3.5-turbo",
        verbose: bool = False,
        *,
        api_key: str | None = None,
        base_url: str | None = None,
        temperature: float | None = None,
        max_tokens: int | None = None,
        top_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        n: int | None = None,
        seed: int | None = None,
        stop: list[str] | str | None = None,
        response_format: dict | None = None,
        tools: list | None = None,
        tool_choice: Any = None,
        logit_bias: dict | None = None,
        logprobs: bool | None = None,
        top_logprobs: int | None = None,
        user: str | None = None,
        timeout: float | None = None,
        usage_tracker: UsageTracker | None = None,
        **openai_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.verbose = verbose
        self.usage = usage_tracker or UsageTracker()
        self.kwargs = dict(openai_kwargs)
        declared = {
            "model": model,
            "api_key": api_key,
            "base_url": base_url,
            "temperature": temperature,
            "max_tokens": max_tokens,
            "top_p": top_p,
            "frequency_penalty": frequency_penalty,
            "presence_penalty": presence_penalty,
            "n": n,
            "seed": seed,
            "stop": stop,
            "response_format": response_format,
            "tools": tools,
            "tool_choice": tool_choice,
            "logit_bias": logit_bias,
            "logprobs": logprobs,
            "top_logprobs": top_logprobs,
            "user": user,
            "timeout": timeout,
        }
        self.kwargs.update({k: v for k, v in declared.items() if v is not None})

    async def __wrapped__(self, messages, **kwargs) -> str | None:
        try:
            import openai
        except ImportError as e:  # pragma: no cover
            raise ImportError("OpenAIChat requires the openai package") from e
        messages = _messages_to_plain(messages)
        kwargs = {**self.kwargs, **kwargs}
        model = kwargs.get("model")
        req_id = self.usage.next_request_id()
        logger.info(
            json.dumps(
                {
                    "_type": "openai_chat_request",
                    "id": req_id,
                    "model": model,
                    "messages": _prep_message_log(messages, self.verbose),
                },
                ensure_ascii=False,
            )
        )
        from ._utils import shared_openai_client

        client = shared_openai_client(
            kwargs.pop("api_key", None), kwargs.pop("base_url", None)
        )
        try:
            ret = await client.chat.completions.create(messages=messages, **kwargs)
        except Exception:
            self.usage.record(model, failed=True)
            raise
        self.usage.record(model, getattr(ret, "usage", None))
        response = ret.choices[0].message.content
        logger.info(
            json.dumps(
                {
                    "_type": "openai_chat_response",
                    "id": req_id,
                    # non-verbose is the privacy posture: no content in
                    # logs on either side of the exchange
                    "response": response if self.verbose else "...",
                },
                ensure_ascii=False,
            )
        )
        return response

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return _check_model_accepts_arg(self.model or "", "openai", arg_name)


class LiteLLMChat(BaseChat):
    """litellm.acompletion wrapper (reference llms.py:313)."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = None,
        verbose: bool = False,
        usage_tracker: UsageTracker | None = None,
        **litellm_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.verbose = verbose
        self.usage = usage_tracker or UsageTracker()
        self.kwargs = dict(litellm_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    async def __wrapped__(self, messages, **kwargs) -> str | None:
        try:
            import litellm
        except ImportError as e:  # pragma: no cover
            raise ImportError("LiteLLMChat requires the litellm package") from e
        messages = _messages_to_plain(messages)
        kwargs = {**self.kwargs, **kwargs}
        logger.info("LiteLLMChat call: %s", _prep_message_log(messages, self.verbose))
        try:
            ret = await litellm.acompletion(messages=messages, **kwargs)
        except Exception:
            self.usage.record(kwargs.get("model"), failed=True)
            raise
        self.usage.record(kwargs.get("model"), getattr(ret, "usage", None))
        return ret.choices[0]["message"]["content"]

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return _check_model_accepts_arg(self.model or "", "litellm", arg_name)


class HFPipelineChat(BaseChat):
    """Local transformers text-generation pipeline (reference llms.py:441).
    Like the port's other entry points it runs on the card unless the caller
    passes ``device="cpu"``. The port's own generation on the card is the
    decode plane (``pathway_tpu_torch.decode``)."""

    def __init__(
        self,
        model: str | None = "gpt2",
        call_kwargs: dict = {},
        device: str | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        **pipeline_kwargs,
    ):
        super().__init__(cache_strategy=cache_strategy)
        self.kwargs = {"model": model}
        self.call_kwargs = dict(call_kwargs)
        try:
            import transformers
        except ImportError as e:  # pragma: no cover
            raise ImportError("HFPipelineChat requires transformers") from e
        self.pipeline = transformers.pipeline(
            "text-generation", model=model, device=resolve_device(device), **pipeline_kwargs
        )
        self.tokenizer = self.pipeline.tokenizer

    def crop_to_max_length(self, input_string: str, max_prompt_length: int = 500) -> str:
        tokens = self.tokenizer.tokenize(input_string)
        if len(tokens) > max_prompt_length:
            tokens = tokens[-max_prompt_length:]
            return self.tokenizer.convert_tokens_to_string(tokens)
        return input_string

    def __wrapped__(self, messages, **kwargs) -> str | None:
        messages_plain = _messages_to_plain(messages)
        kwargs = {**self.call_kwargs, **kwargs}
        if getattr(self.tokenizer, "chat_template", None) is not None:
            prompt_input: Any = messages_plain
        else:
            prompt_input = "\n".join(m.get("content", "") for m in messages_plain)
        output = self.pipeline(prompt_input, **kwargs)
        text = output[0]["generated_text"]
        if isinstance(text, list):  # chat-format output
            return text[-1].get("content")
        return text

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return arg_name in {"max_new_tokens", "temperature", "top_p", "do_sample"}


class CohereChat(BaseChat):
    """Cohere chat wrapper with RAG citations (reference llms.py:544).
    Returns (response_text, cited_documents)."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "command",
        **cohere_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(cohere_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    @staticmethod
    def _to_cohere_history(messages: list[dict]) -> tuple[list[dict], str]:
        history = [
            {"role": m.get("role", "user"), "message": m.get("content", "")}
            for m in messages[:-1]
        ]
        last = messages[-1].get("content", "") if messages else ""
        return history, last

    def __wrapped__(self, messages, docs: list[dict] | None = None, **kwargs) -> tuple:
        try:
            import cohere
        except ImportError as e:  # pragma: no cover
            raise ImportError("CohereChat requires the cohere package") from e
        messages = _messages_to_plain(messages)
        history, message = self._to_cohere_history(messages)
        kwargs = {**self.kwargs, **kwargs}
        client = cohere.Client()
        response = client.chat(
            chat_history=history, message=message, documents=docs, **kwargs
        )
        cited = [dict(d) for d in (response.citations or [])] if hasattr(response, "citations") else []
        return response.text, cited

    def __call__(self, messages: ColumnExpression, documents=None, **kwargs) -> ColumnExpression:
        if documents is not None:
            return super(BaseChat, self).__call__(messages, docs=documents, **kwargs)
        return super().__call__(messages, **kwargs)

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return _check_model_accepts_arg(self.model or "", "cohere", arg_name)


@udfs.udf
def prompt_chat_single_qa(question: str) -> Json:
    """Wrap a plain question into a single-turn chat message list
    (reference llms.py:686). A UDF: call it on a column expression."""
    return Json([{"role": "user", "content": question}])
