"""OpenAPI endpoint documentation, schema validation and structured
request logging for the REST connector.

The port's copy of the reference's ``io/http/_docs.py`` (upstream
Pathway's python/pathway/io/http/_server.py:30-327: EndpointExamples :89,
EndpointDocumentation :125, _LoggingContext :53, _request_scheme :304,
the engine-type -> OpenAPI maps :30-47). The request objects it reads
are the port's standard-library server's (``_server._Request``).
"""

from __future__ import annotations

import copy
import json
import logging
import time
from typing import Any, Sequence

from ...internals import dtype as dt

logger = logging.getLogger(__name__)

_DTYPE_TO_OPENAPI_TYPE: dict[Any, str] = {
    dt.INT: "number",
    dt.STR: "string",
    dt.BOOL: "boolean",
    dt.FLOAT: "number",
    dt.POINTER: "string",
    dt.DATE_TIME_NAIVE: "string",
    dt.DATE_TIME_UTC: "string",
    dt.DURATION: "string",
    dt.BYTES: "bytes",
}

_DTYPE_TO_OPENAPI_FORMAT: dict[Any, str] = {
    dt.INT: "int64",
    dt.FLOAT: "double",
}

#: schema column carrying the payload for 'raw'-format endpoints
QUERY_SCHEMA_COLUMN = "query"


def _openapi_type(dtype) -> str | None:
    return _DTYPE_TO_OPENAPI_TYPE.get(dt.unoptionalize(dtype))


class EndpointExamples:
    """Named request examples rendered into the endpoint's OpenAPI docs
    (reference :89). ``default`` as an id pre-selects the example."""

    def __init__(self):
        self.examples_by_id: dict[str, dict] = {}

    def add_example(self, id, summary, values):
        if id in self.examples_by_id:
            raise ValueError(f"Duplicate example id: {id}")
        self.examples_by_id[id] = {"summary": summary, "value": values}
        return self

    def _openapi_description(self) -> dict:
        return self.examples_by_id


class EndpointDocumentation:
    """Automatic OpenAPI v3 docs for one endpoint (reference :125).

    Args:
        summary: short description shown in the endpoints list.
        description: comprehensive endpoint description.
        tags: grouping tags.
        method_types: when set, only these methods are documented.
        examples: EndpointExamples rendered into the request body docs.
    """

    DEFAULT_RESPONSES_DESCRIPTION = {
        "200": {"description": "OK"},
        "400": {
            "description": "The request is incorrect. Please check if "
            "it complies with the auto-generated and Pathway input "
            "table schemas"
        },
    }

    def __init__(
        self,
        *,
        summary: str | None = None,
        description: str | None = None,
        tags: Sequence[str] | None = None,
        method_types: Sequence[str] | None = None,
        examples: EndpointExamples | None = None,
    ):
        self.summary = summary
        self.description = description
        self.tags = tags
        self.method_types = (
            {m.upper() for m in method_types} if method_types is not None else None
        )
        self.examples = examples

    def _is_method_exposed(self, method: str) -> bool:
        return self.method_types is None or method.upper() in self.method_types

    def generate_docs(self, format: str, method: str, schema) -> dict:
        """Per-method OpenAPI description: GET documents query params,
        other methods a request body (text/plain for 'raw' endpoints,
        an object schema for 'custom' ones)."""
        if not self._is_method_exposed(method):
            return {}
        if method.upper() == "GET":
            endpoint_description: dict = {
                "parameters": self._openapi_get_request_schema(schema),
                "responses": copy.deepcopy(self.DEFAULT_RESPONSES_DESCRIPTION),
            }
        else:
            if format == "raw":
                content_header = "text/plain"
                openapi_schema = self._openapi_plaintext_schema(schema)
            elif format == "custom":
                content_header = "application/json"
                openapi_schema = self._openapi_json_schema(schema)
            else:
                raise ValueError(f"Unknown endpoint input format: {format}")
            schema_and_examples: dict = {"schema": openapi_schema}
            if self.examples:
                schema_and_examples["examples"] = self.examples._openapi_description()
            endpoint_description = {
                "requestBody": {"content": {content_header: schema_and_examples}},
                "responses": copy.deepcopy(self.DEFAULT_RESPONSES_DESCRIPTION),
            }
        if self.tags is not None:
            endpoint_description["tags"] = list(self.tags)
        if self.description is not None:
            endpoint_description["description"] = self.description
        if self.summary is not None:
            endpoint_description["summary"] = self.summary
        return {method.lower(): endpoint_description}

    @staticmethod
    def _optional_traits(props) -> dict:
        out = {}
        if getattr(props, "example", None) is not None:
            out["example"] = props.example
        if getattr(props, "description", None) is not None:
            out["description"] = props.description
        return out

    def _openapi_plaintext_schema(self, schema) -> dict:
        query_column = schema.columns().get(QUERY_SCHEMA_COLUMN)
        if query_column is None:
            raise ValueError(
                "'raw' endpoint input format requires 'query' column in schema"
            )
        description: dict = {"type": _openapi_type(query_column.dtype) or "string"}
        fmt = _DTYPE_TO_OPENAPI_FORMAT.get(dt.unoptionalize(query_column.dtype))
        if fmt:
            description["format"] = fmt
        if query_column.has_default_value:
            description["default"] = query_column.default_value
        description.update(self._optional_traits(query_column))
        return description

    def _openapi_get_request_schema(self, schema) -> list:
        parameters = []
        for name, props in schema.columns().items():
            field: dict = {
                "in": "query",
                "name": name,
                "required": not props.has_default_value,
            }
            field.update(self._optional_traits(props))
            # a param without a type makes the schema invalid
            field["schema"] = {"type": _openapi_type(props.dtype) or "string"}
            parameters.append(field)
        return parameters

    def _openapi_json_schema(self, schema) -> dict:
        properties: dict = {}
        required: list[str] = []
        additional_properties = False
        for name, props in schema.columns().items():
            openapi_type = _openapi_type(props.dtype)
            if openapi_type is None:
                # JSON/tuple/array columns: no crisp scalar type — the
                # endpoint accepts them as free-form extra properties
                additional_properties = True
                continue
            field: dict = {"type": openapi_type}
            if not props.has_default_value:
                required.append(name)
            else:
                field["default"] = props.default_value
            field.update(self._optional_traits(props))
            fmt = _DTYPE_TO_OPENAPI_FORMAT.get(dt.unoptionalize(props.dtype))
            if fmt is not None:
                field["format"] = fmt
            properties[name] = field
        result: dict = {
            "type": "object",
            "properties": properties,
            "additionalProperties": additional_properties,
        }
        if required:
            result["required"] = required
        return result


_PYTHON_TYPE_BY_DTYPE = {
    dt.INT: int,
    dt.FLOAT: (int, float),
    dt.STR: str,
    dt.BOOL: bool,
}


def validate_payload(payload: dict, schema) -> str | None:
    """Validate a decoded request payload against the endpoint schema:
    missing required fields and scalar type mismatches produce the 400
    message; None accepts (reference: the engine rejects mistyped rows,
    here we answer at the HTTP layer as the docs promise)."""
    if not isinstance(payload, dict):
        return "request payload must be a JSON object"
    problems = []
    for name, props in schema.columns().items():
        if name == "id":
            continue
        present = name in payload and payload[name] is not None
        if not present:
            optional = isinstance(props.dtype, dt.Optional) or props.dtype in (
                dt.ANY,
                dt.JSON,
            )
            if not props.has_default_value and not optional:
                problems.append(f"missing required field {name!r}")
            continue
        expected = _PYTHON_TYPE_BY_DTYPE.get(dt.unoptionalize(props.dtype))
        if expected is not None and not isinstance(payload[name], expected):
            problems.append(
                f"field {name!r} expects {dt.unoptionalize(props.dtype)}, "
                f"got {type(payload[name]).__name__}"
            )
        if expected is int and isinstance(payload[name], bool):
            problems.append(f"field {name!r} expects INT, got bool")
    if problems:
        return "; ".join(problems)
    return None


def _request_scheme(request) -> str:
    """Scheme honoring forwarded-proto headers (reference :304)."""
    for header in ("X-Forwarded-Proto", "X-Scheme", "X-Forwarded-Scheme"):
        value = request.headers.get(header)
        if value is not None and value.lower() in ("http", "https"):
            return value.lower()
    return request.scheme


class _LoggingContext:
    """One structured JSON access-log record per request (reference
    :53-86): request facts at entry, status + elapsed at exit; 4xx/5xx
    log at error level."""

    def __init__(self, request, session_id: str):
        self.log: dict = {
            "_type": "http_access",
            "method": request.method,
            "scheme": request.scheme,
            "scheme_with_forwarded": _request_scheme(request),
            "host": request.host,
            "route": str(request.rel_url),
            "content_type": request.headers.get("Content-Type"),
            "user_agent": request.headers.get("User-Agent"),
            "unix_timestamp": int(time.time()),
            "remote": request.remote,
            "session_id": session_id,
            "headers": [
                {"header": header, "value": value}
                for header, value in request.headers.items()
            ],
        }
        self.request_start = time.time()

    def log_response(self, status: int) -> None:
        self.log["status"] = status
        self.log["time_elapsed"] = "{:.3f}".format(time.time() - self.request_start)
        if status < 400:
            logger.info(json.dumps(self.log))
        else:
            logger.error(json.dumps(self.log))
