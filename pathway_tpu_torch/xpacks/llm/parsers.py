"""Document parser UDFs: bytes -> list[(text, metadata)].

The port's copy of the reference's ``xpacks/llm/parsers.py`` (upstream
Pathway's python/pathway/xpacks/llm/parsers.py: ParseUtf8 :53,
ParseUnstructured :79, OpenParse :235, ImageParser :396, SlideParser :569,
PypdfParser :746, parse_images :835). Parsers requiring optional packages
(unstructured, openparse, pypdf, PIL, pdf2image) import lazily and raise
the reference's ImportError when absent; the vision-model plumbing runs
against any chat UDF (see _parser_utils) so every parser unit-tests with
fakes.
"""

from __future__ import annotations

import logging
import os
import re
import subprocess
import tempfile
from io import BytesIO
from typing import Any, Callable

from ...internals import udfs
from ...internals.expression import ColumnExpression
from . import prompts
from ._parser_utils import (
    img_to_b64,
    maybe_downscale,
    parse,
    parse_b64_images,
    parse_image_details,
    parse_images,
    schema_dump,
    schema_dump_json,
)

logger = logging.getLogger(__name__)


class ParseUtf8(udfs.UDF):
    """Decode bytes as UTF-8; whole file is one chunk (reference :53)."""

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        if isinstance(contents, str):
            return [(contents, {})]
        return [(contents.decode("utf-8", errors="replace"), {})]

    def __call__(self, contents: ColumnExpression, **kwargs) -> ColumnExpression:
        return super().__call__(contents, **kwargs)


#: reference keeps both names
Utf8Parser = ParseUtf8

_UNSTRUCTURED_MODES = ("single", "elements", "paged")


class ParseUnstructured(udfs.UDF):
    """unstructured.io partition-based parser (reference :79-233).

    ``mode``: ``single`` (whole document, one chunk, merged metadata),
    ``elements`` (one chunk per unstructured element), or ``paged`` (one
    chunk per page, per-page merged metadata).  ``post_processors``
    apply to every element; extra ``unstructured_kwargs`` forward to
    unstructured's ``partition``.  All arguments can be overridden per
    call."""

    def __init__(
        self,
        mode: str = "single",
        post_processors: list[Callable] | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        **unstructured_kwargs: Any,
    ):
        try:
            import unstructured.partition.auto  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "ParseUnstructured requires the unstructured package"
            ) from e
        super().__init__(cache_strategy=cache_strategy)
        if mode not in _UNSTRUCTURED_MODES:
            raise ValueError(
                f"Got {mode} for `mode`, but should be one of `{set(_UNSTRUCTURED_MODES)}`"
            )
        self.kwargs = dict(
            mode=mode,
            post_processors=post_processors or [],
            unstructured_kwargs=unstructured_kwargs,
        )

    @staticmethod
    def _combine_metadata(left: dict, right: dict) -> dict:
        """Merge element metadata: concatenate links, union languages,
        drop per-element fields (coordinates/parent_id/category_depth)
        that make no sense on a merged chunk (reference :118-131)."""
        left, right = dict(left), dict(right)
        links = left.pop("links", []) + right.pop("links", [])
        languages = sorted(set(left.pop("languages", [])) | set(right.pop("languages", [])))
        result = {**left, **right}
        result["links"] = links
        result["languages"] = languages
        for key in ("coordinates", "parent_id", "category_depth"):
            result.pop(key, None)
        return result

    @staticmethod
    def _element_metadata(element) -> dict:
        meta = (
            element.metadata.to_dict() if hasattr(element, "metadata") else {}
        )
        return meta

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import unstructured.partition.auto

        kwargs = {**self.kwargs, **kwargs}
        elements = unstructured.partition.auto.partition(
            file=BytesIO(contents), **kwargs.pop("unstructured_kwargs")
        )
        for element in elements:
            for post_processor in kwargs["post_processors"]:
                element.apply(post_processor)
        kwargs.pop("post_processors")
        mode = kwargs.pop("mode")
        if kwargs:
            raise ValueError(f"Unknown arguments: {', '.join(kwargs.keys())}")
        if mode not in _UNSTRUCTURED_MODES:
            raise ValueError(f"mode of {mode} not supported.")

        if mode == "elements":
            docs: list[tuple[str, dict]] = []
            for element in elements:
                metadata = self._element_metadata(element)
                if hasattr(element, "category"):
                    metadata["category"] = element.category
                docs.append((str(element), metadata))
            return docs
        if mode == "paged":
            text_by_page: dict[int, str] = {}
            meta_by_page: dict[int, dict] = {}
            for element in elements:
                metadata = self._element_metadata(element)
                page = metadata.get("page_number", 1)
                if page not in text_by_page:
                    text_by_page[page] = str(element) + "\n\n"
                    meta_by_page[page] = metadata
                else:
                    text_by_page[page] += str(element) + "\n\n"
                    meta_by_page[page] = self._combine_metadata(
                        meta_by_page[page], metadata
                    )
            return [(text_by_page[p], meta_by_page[p]) for p in text_by_page]
        # single
        metadata: dict = {}
        for element in elements:
            metadata = self._combine_metadata(
                metadata, self._element_metadata(element)
            )
        return [("\n\n".join(str(el) for el in elements), metadata)]

    def __call__(self, contents: ColumnExpression, **kwargs) -> ColumnExpression:
        return super().__call__(contents, **kwargs)


class PypdfParser(udfs.UDF):
    """pypdf text extraction, one chunk per page, with the reference's
    three-step text cleanup (reference :746-831)."""

    def __init__(self, apply_text_cleanup: bool = True, cache_strategy=None):
        try:
            import pypdf  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError("PypdfParser requires the pypdf package") from e
        super().__init__(cache_strategy=cache_strategy)
        self.apply_text_cleanup = apply_text_cleanup

    def _clean_text(self, text: str) -> str:
        return self._replace_newline_with_space_if_lower(
            self._remove_empty_space(self._clean_text_lines(text))
        )

    @staticmethod
    def _clean_text_lines(text: str) -> str:
        """Strip indentation that pypdf leaves before capitalized/numeric
        line starts (reference :816)."""
        return re.sub(
            r"(?<=\n)\s*([A-Z][^ ]*|[\d][^ ]*)", lambda m: m.group(1), text
        ).replace("\n ", "\n")

    @staticmethod
    def _remove_empty_space(text: str) -> str:
        return text.replace("   ", " ")

    @staticmethod
    def _replace_newline_with_space_if_lower(text: str) -> str:
        """Unwrap soft line breaks: a newline followed by a lowercase
        letter is a wrap, not a paragraph (reference :824)."""

        def replace_newline(match: re.Match) -> str:
            if match.group(1).islower():
                return " " + match.group(1)
            return "\n" + match.group(1)

        return re.sub(r"\n(\w)", replace_newline, text)

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import pypdf

        pdf = pypdf.PdfReader(stream=BytesIO(contents))
        logger.info(
            "PypdfParser starting to parse a document of length: %d", len(pdf.pages)
        )
        docs: list[tuple[str, dict]] = []
        for page in pdf.pages:
            text = page.extract_text() or ""
            if self.apply_text_cleanup:
                text = self._clean_text(text)
            docs.append((text, {"page_number": page.page_number}))
        return docs


class ImageParser(udfs.UDF):
    """Describe images with a vision chat UDF; optionally extract a
    structured schema in a second pass (reference :396-533).

    ``detail_parse_schema``: a pydantic model (or any annotated class) —
    when given, each image gets a second LLM call extracting those
    fields into the chunk metadata. ``include_schema_in_text`` appends
    the extracted JSON to the description (helps retrieval).
    ``run_mode``: ``parallel`` gathers all calls, ``sequential`` bounds
    concurrency to one (local models)."""

    def __init__(
        self,
        llm=None,
        parse_prompt: str = prompts.DEFAULT_IMAGE_PARSE_PROMPT,
        detail_parse_schema: type | None = None,
        include_schema_in_text: bool = False,
        downsize_horizontal_width: int = 1280,
        max_image_size: int = 15 * 1024 * 1024,
        run_mode: str = "parallel",
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
    ):
        super().__init__(cache_strategy=cache_strategy)
        if llm is None:
            raise ValueError("ImageParser requires a vision-capable llm")
        if run_mode not in ("sequential", "parallel"):
            raise ValueError(f"invalid run_mode: {run_mode}")
        self.llm = llm
        self.parse_prompt = parse_prompt
        self.detail_parse_schema = detail_parse_schema
        self.parse_details = detail_parse_schema is not None
        if not self.parse_details and include_schema_in_text:
            raise ValueError(
                "`include_schema_in_text` is set to `True` but no "
                "`detail_parse_schema` provided. Please provide a "
                "`detail_parse_schema` or set `include_schema_in_text` to `False`."
            )
        self.include_schema_in_text = include_schema_in_text
        self.downsize_horizontal_width = downsize_horizontal_width
        self.max_image_size = max_image_size
        self.run_mode = run_mode
        self.retry_strategy = retry_strategy
        self.parse_fn = (
            udfs.with_retry_strategy(parse, retry_strategy)
            if retry_strategy is not None
            else parse
        )
        self.parse_image_details_fn = None
        if self.parse_details:

            async def _details(b64_img, parse_schema):
                return await parse_image_details(b64_img, parse_schema, llm=self.llm)

            self.parse_image_details_fn = (
                udfs.with_retry_strategy(_details, retry_strategy)
                if retry_strategy is not None
                else _details
            )

    def _docs_from(
        self, parsed_content: list[str], parsed_details: list, extra_meta=None
    ) -> list[tuple[str, dict]]:
        docs = []
        for idx, text in enumerate(parsed_content):
            if self.include_schema_in_text:
                text = text + "\n" + schema_dump_json(parsed_details[idx])
            meta = dict(extra_meta(idx)) if extra_meta is not None else {}
            if self.parse_details:
                meta.update(schema_dump(parsed_details[idx]))
            docs.append((text, meta))
        return docs

    async def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        from PIL import Image

        images = [Image.open(BytesIO(contents))]
        images = [
            maybe_downscale(img, self.max_image_size, self.downsize_horizontal_width)
            for img in images
        ]
        parsed_content, parsed_details = await parse_images(
            images,
            self.llm,
            self.parse_prompt,
            run_mode=self.run_mode,
            parse_details=self.parse_details,
            detail_parse_schema=self.detail_parse_schema,
            parse_fn=self.parse_fn,
            parse_image_details_fn=self.parse_image_details_fn,
        )
        logger.info(
            "ImageParser completed parsing, total number of images: %d",
            len(parsed_content),
        )
        return self._docs_from(parsed_content, parsed_details)


def _convert_pptx_to_pdf(contents: bytes) -> bytes:
    """PPTX -> PDF through headless LibreOffice (reference :536-566)."""
    with tempfile.NamedTemporaryFile(suffix=".pptx", delete=False) as pptx_temp:
        pptx_temp.write(contents)
        pptx_path = pptx_temp.name
    pdf_path = os.path.basename(pptx_path).replace(".pptx", ".pdf")
    try:
        result = subprocess.run(
            ["soffice", "--headless", "--convert-to", "pdf", pptx_path],
            check=True,
            capture_output=True,
            text=True,
        )
        logger.info("`_convert_pptx_to_pdf` result: %s", result)
        with open(pdf_path, "rb") as pdf_temp:
            return pdf_temp.read()
    except FileNotFoundError:
        raise Exception(
            "`LibreOffice` is not installed or `soffice` command is not "
            "found. Please install LibreOffice."
        )
    finally:
        os.remove(pptx_path)
        if os.path.exists(pdf_path):
            os.remove(pdf_path)


class SlideParser(ImageParser):
    """Parse PPTX/PDF slide decks page-by-page through a vision model
    (reference :569-744): PPTX converts via LibreOffice, PDFs render to
    images (pdf2image), each page is described (and optionally
    schema-parsed); metadata carries the rendered page image
    (``b64_image``), its index and the deck page count."""

    def __init__(
        self,
        llm=None,
        parse_prompt: str = prompts.DEFAULT_IMAGE_PARSE_PROMPT,
        detail_parse_schema: type | None = None,
        include_schema_in_text: bool = False,
        intermediate_image_format: str = "jpg",
        image_size: tuple[int, int] = (1280, 720),
        run_mode: str = "parallel",
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
    ):
        try:
            from pdf2image import convert_from_bytes  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError("SlideParser requires the pdf2image package") from e
        super().__init__(
            llm=llm,
            parse_prompt=parse_prompt,
            detail_parse_schema=detail_parse_schema,
            include_schema_in_text=include_schema_in_text,
            run_mode=run_mode,
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )
        self.intermediate_image_format = intermediate_image_format
        self.image_size = image_size

    @staticmethod
    def _is_pptx(contents: bytes) -> bool:
        # PPTX is a zip; probe for the ppt/ payload without unstructured
        if not contents.startswith(b"PK"):
            return False
        import zipfile

        try:
            with zipfile.ZipFile(BytesIO(contents)) as z:
                return any(n.startswith("ppt/") for n in z.namelist())
        except zipfile.BadZipFile:
            return False

    async def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        from pdf2image import convert_from_bytes

        if self._is_pptx(contents):
            logger.info("`SlideParser` converting PPTX to PDF from byte object.")
            contents = _convert_pptx_to_pdf(contents)
        try:
            images = convert_from_bytes(
                contents, fmt=self.intermediate_image_format, size=self.image_size
            )
        except Exception:
            logger.info(
                "Failed to extract images in `%s` format, trying the default.",
                self.intermediate_image_format,
            )
            images = convert_from_bytes(contents, size=self.image_size)
        b64_images = [img_to_b64(image) for image in images]
        parsed_content, parsed_details = await parse_b64_images(
            b64_images,
            self.llm,
            self.parse_prompt,
            run_mode=self.run_mode,
            parse_details=self.parse_details,
            detail_parse_schema=self.detail_parse_schema,
            parse_fn=self.parse_fn,
            parse_image_details_fn=self.parse_image_details_fn,
        )
        page_count = len(images)
        return self._docs_from(
            parsed_content,
            parsed_details,
            extra_meta=lambda idx: {
                "b64_image": b64_images[idx],
                "image_page": idx,
                "tot_pages": page_count,
            },
        )


class OpenParse(udfs.UDF):
    """openparse-based PDF chunking (reference :235-394): pymupdf text
    ingestion + table extraction (llm / pymupdf / unitable /
    table-transformers algorithms) + optional vision-LLM image parsing,
    post-processed by an ingestion pipeline.

    ``processing_pipeline``: ``"pathway_pdf_default"``
    (SimpleIngestionPipeline), ``"merge_same_page"``
    (SamePageIngestionPipeline), or any openparse IngestionPipeline."""

    def __init__(
        self,
        table_args: dict | None = None,
        image_args: dict | None = None,
        parse_images: bool = False,
        processing_pipeline=None,
        llm=None,
        cache_strategy=None,
    ):
        try:
            import openparse  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError("OpenParse requires the openparse package") from e
        from .openparse_utils import (
            PyMuDocumentParser,
            SamePageIngestionPipeline,
            SimpleIngestionPipeline,
        )

        super().__init__(cache_strategy=cache_strategy)
        if table_args is None:
            table_args = {
                "parsing_algorithm": "llm",
                "llm": llm,
                "prompt": prompts.DEFAULT_MD_TABLE_PARSE_PROMPT,
            }
        if parse_images:
            if image_args is None:
                image_args = {
                    "parsing_algorithm": "llm",
                    "llm": llm,
                    "prompt": prompts.DEFAULT_IMAGE_PARSE_PROMPT,
                }
            elif image_args.get("parsing_algorithm") != "llm":
                raise ValueError(
                    "Image parsing is only supported with LLMs. Either change "
                    "the `parsing_algorithm` to `llm` or set `parse_images` to "
                    f"`False`. Given args: {image_args}"
                )
        else:
            if image_args:
                logger.warning(
                    "`parse_images` is False but `image_args` is set; skipping "
                    "image parsing."
                )
            image_args = None
        if processing_pipeline is None or processing_pipeline == "pathway_pdf_default":
            processing_pipeline = SimpleIngestionPipeline()
        elif processing_pipeline == "merge_same_page":
            processing_pipeline = SamePageIngestionPipeline()
        elif isinstance(processing_pipeline, str):
            raise ValueError(
                "Invalid `processing_pipeline` set. It must be either one of "
                "`'pathway_pdf_default'` or `'merge_same_page'`."
            )
        self.doc_parser = PyMuDocumentParser(
            table_args=table_args,
            image_args=image_args,
            processing_pipeline=processing_pipeline,
        )

    async def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import openparse

        try:
            from pypdf import PdfReader

            doc = openparse.Pdf(file=PdfReader(stream=BytesIO(contents)))
        except ImportError:
            doc = openparse.Pdf(file=BytesIO(contents))
        parsed = self.doc_parser.parse(doc)
        nodes = list(parsed.nodes)
        logger.info(
            "OpenParse completed parsing, total number of nodes: %d", len(nodes)
        )
        return [(node.model_dump()["text"], {}) for node in nodes]


__all__ = [
    "ImageParser",
    "OpenParse",
    "ParseUnstructured",
    "ParseUtf8",
    "PypdfParser",
    "SlideParser",
    "Utf8Parser",
]
