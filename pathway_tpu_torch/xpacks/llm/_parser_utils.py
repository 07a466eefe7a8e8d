"""Vision-parsing helpers shared by ImageParser/SlideParser/OpenParse.

The port's copy of the reference's ``xpacks/llm/_parser_utils.py``
(upstream Pathway's python/pathway/xpacks/llm/_parser_utils.py:
img_to_b64, parse, parse_image_details) plus the parse_images /
_parse_b64_images drivers from upstream parsers.py:835-928.  Divergence
from the reference: schema extraction routes through the SAME provided
llm UDF (a vision chat asked for strict JSON) instead of a hard
dependency on the openai client + instructor, so it works with any chat
backend and unit-tests with fakes.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import re
from io import BytesIO
from typing import Any, Callable

from ...engine.value import Json
from ._utils import coerce_async

logger = logging.getLogger(__name__)


def img_to_b64(image, format: str = "JPEG") -> str:
    """PIL image -> base64 string (reference _parser_utils.img_to_b64)."""
    buf = BytesIO()
    if format.upper() in ("JPG", "JPEG") and image.mode not in ("RGB", "L"):
        image = image.convert("RGB")
    image.save(buf, format=format)
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def maybe_downscale(img, max_image_size: int, downsize_horizontal_width: int):
    """Downscale the image when its raw size exceeds ``max_image_size``
    bytes (reference parsers.py maybe_downscale): resize to
    ``downsize_horizontal_width`` keeping aspect ratio."""
    n_bytes = len(img.tobytes())
    if n_bytes <= max_image_size or img.width <= downsize_horizontal_width:
        return img
    ratio = downsize_horizontal_width / img.width
    new_size = (downsize_horizontal_width, max(1, int(img.height * ratio)))
    logger.info(
        "Image size %d exceeds %d bytes; downscaling %s -> %s",
        n_bytes,
        max_image_size,
        (img.width, img.height),
        new_size,
    )
    return img.resize(new_size)


def _vision_messages(b64_img: str, prompt: str) -> Json:
    return Json(
        [
            {
                "role": "user",
                "content": [
                    {"type": "text", "text": prompt},
                    {
                        "type": "image_url",
                        "image_url": {"url": f"data:image/jpeg;base64,{b64_img}"},
                    },
                ],
            }
        ]
    )


async def parse(b64_img: str, llm, prompt: str, model: str | None = None) -> str:
    """One vision-LLM call: describe ``b64_img`` per ``prompt``."""
    fn = coerce_async(llm)
    kwargs: dict[str, Any] = {}
    if model is not None:
        kwargs["model"] = model
    out = await fn(_vision_messages(b64_img, prompt), **kwargs)
    return out or ""


def _schema_fields(parse_schema: type) -> dict[str, Any]:
    """Field name -> annotation for a pydantic model or any annotated
    class (our schema contract: annotations define the fields)."""
    fields = getattr(parse_schema, "model_fields", None)
    if fields is not None:  # pydantic v2
        return {name: f.annotation for name, f in fields.items()}
    return dict(getattr(parse_schema, "__annotations__", {}))


def _coerce_schema(parse_schema: type, data: dict):
    """Instantiate the schema from a parsed-JSON dict. Pydantic models
    validate; plain annotated classes get attributes set directly."""
    if hasattr(parse_schema, "model_validate"):
        return parse_schema.model_validate(data)
    obj = parse_schema.__new__(parse_schema)
    for name in _schema_fields(parse_schema):
        setattr(obj, name, data.get(name))
    return obj


_JSON_BLOCK = re.compile(r"\{.*\}", re.DOTALL)


async def parse_image_details(
    b64_img: str,
    parse_schema: type,
    llm=None,
    model: str | None = None,
    prompt: str | None = None,
    **_client_args,
):
    """Second-pass schema extraction (reference
    _parser_utils.parse_image_details): ask the vision LLM for strict
    JSON matching ``parse_schema``'s fields and validate into it."""
    fields = _schema_fields(parse_schema)
    if prompt is None:
        prompt = (
            "Extract the following fields from the image and answer with a "
            "single JSON object only (no prose, no code fences): "
            + ", ".join(f"{n} ({getattr(t, '__name__', t)})" for n, t in fields.items())
        )
    raw = await parse(b64_img, llm, prompt, model=model)
    match = _JSON_BLOCK.search(raw or "")
    if match is None:
        raise ValueError(
            f"vision LLM returned no JSON object for schema "
            f"{parse_schema.__name__}: {raw[:200]!r}"
        )
    return _coerce_schema(parse_schema, json.loads(match.group(0)))


async def parse_images(
    images: list,
    llm,
    parse_prompt: str,
    *,
    run_mode: str = "parallel",
    parse_details: bool = False,
    detail_parse_schema: type | None = None,
    parse_fn: Callable,
    parse_image_details_fn: Callable | None,
) -> tuple[list[str], list]:
    """Describe (and optionally schema-parse) PIL images (reference
    parsers.py:835)."""
    b64_images = [img_to_b64(image) for image in images]
    return await parse_b64_images(
        b64_images,
        llm,
        parse_prompt,
        run_mode=run_mode,
        parse_details=parse_details,
        detail_parse_schema=detail_parse_schema,
        parse_fn=parse_fn,
        parse_image_details_fn=parse_image_details_fn,
    )


async def parse_b64_images(
    b64_images: list[str],
    llm,
    parse_prompt: str,
    *,
    run_mode: str,
    parse_details: bool,
    detail_parse_schema: type | None,
    parse_fn: Callable,
    parse_image_details_fn: Callable | None,
) -> tuple[list[str], list]:
    """The driver (reference _parse_b64_images parsers.py:884):
    sequential mode awaits one call at a time (bounded memory for local
    models); parallel mode gathers every description + detail call."""
    if parse_details and detail_parse_schema is None:
        raise ValueError(
            "`detail_parse_schema` must be provided when `parse_details` is True"
        )
    parsed_details: list = []
    if run_mode == "sequential":
        parsed_content = []
        for img in b64_images:
            parsed_content.append(await parse_fn(img, llm, parse_prompt))
        if parse_details:
            assert parse_image_details_fn is not None
            for img in b64_images:
                parsed_details.append(
                    await parse_image_details_fn(img, parse_schema=detail_parse_schema)
                )
    else:
        parse_tasks = [parse_fn(img, llm, parse_prompt) for img in b64_images]
        detail_tasks = (
            [
                parse_image_details_fn(img, parse_schema=detail_parse_schema)
                for img in b64_images
            ]
            if parse_details and parse_image_details_fn is not None
            else []
        )
        results = await asyncio.gather(*parse_tasks, *detail_tasks)
        parsed_content = list(results[: len(b64_images)])
        parsed_details = list(results[len(b64_images) :])
    return parsed_content, parsed_details


def schema_dump(obj) -> dict:
    """model_dump() for pydantic, annotated attributes otherwise."""
    if hasattr(obj, "model_dump"):
        return obj.model_dump()
    return {n: getattr(obj, n, None) for n in _schema_fields(type(obj))}


def schema_dump_json(obj) -> str:
    if hasattr(obj, "model_dump_json"):
        return obj.model_dump_json()
    return json.dumps(schema_dump(obj))
