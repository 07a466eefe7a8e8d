"""openparse ingestion pipelines.

The port's copy of the reference's ``xpacks/llm/openparse_utils.py``
(upstream Pathway's python/pathway/xpacks/llm/openparse_utils.py :49-409)
— SimpleIngestionPipeline, PageChunker / SamePageIngestionPipeline, the
llm table/image ingestors, the ``ingest`` dispatcher and
PyMuDocumentParser. Upstream imports the optional ``openparse`` package at
module top; here every openparse-derived class materializes lazily on
first attribute access, so importing this module always works and using a
name raises ImportError only when the package is actually absent.
``LLMArgs`` is a pydantic model built on its first access too, so that
importing the module (and ``xpacks.llm``) never needs ``pydantic``.

Divergences from the reference: vision calls route through the
provided chat UDF (``_parser_utils.parse``) rather than a hard openai
dependency, and the surya-based image ingestor degrades to an
actionable ImportError when the local-vision stack is missing.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Literal

from ._parser_utils import parse
from ._utils import _run_async
from .prompts import DEFAULT_MD_TABLE_PARSE_PROMPT

logger = logging.getLogger(__name__)

_LAZY_NAMES = (
    "SimpleIngestionPipeline",
    "PageChunker",
    "SamePageIngestionPipeline",
    "PyMuDocumentParser",
    "ingest",
    "_ingest_with_llm",
    "_ingest_images_with_llm",
    "_table_args_dict_to_model",
)


def _llm_args() -> type:
    """``LLMArgs``, the pydantic model, built on first use."""
    if "LLMArgs" not in globals():
        from pydantic import BaseModel, ConfigDict, Field

        class LLMArgs(BaseModel):
            """Table/image parsing arguments for the ``"llm"`` algorithm
            (reference openparse_utils.py:49)."""

            parsing_algorithm: Literal["llm"] = Field(default="llm")
            min_table_confidence: float = Field(default=0.7, ge=0.0, le=1.0)
            llm: Any = Field(default=None)
            llm_model: str | None = Field(default=None)
            prompt: str = Field(default=DEFAULT_MD_TABLE_PARSE_PROMPT)

            model_config = ConfigDict(extra="forbid")

        LLMArgs.__qualname__ = "LLMArgs"  # pickled by reference to the module attribute
        globals()["LLMArgs"] = LLMArgs
    return globals()["LLMArgs"]


async def parse_image_list(
    image_list: list[str], llm, prompt: str, llm_model: str | None
):
    """Describe every (b64) image concurrently (reference :146)."""
    return await asyncio.gather(
        *[parse(img, llm, prompt, model=llm_model) for img in image_list]
    )


def _build_lazy() -> dict:
    """Construct the openparse-derived classes (called on first access;
    raises ImportError when openparse is absent)."""
    import openparse
    from openparse import DocumentParser, consts, tables, text
    from openparse.pdf import Pdf
    from openparse.processing import (
        CombineNodesSpatially,
        IngestionPipeline,
        ProcessingStep,
    )
    from openparse.processing.basic_transforms import (
        CombineBullets,
        CombineHeadingsWithClosestText,
        RemoveFullPageStubs,
        RemoveMetadataElements,
        RemoveNodesBelowNTokens,
        RemoveRepeatedElements,
        RemoveTextInsideTables,
    )
    from openparse.schemas import Bbox, Node, ParsedDocument, TableElement

    LLMArgs = _llm_args()

    class SimpleIngestionPipeline(IngestionPipeline):
        """Combine close elements, join headings with their text body,
        drop stubs/noise (reference :75 — tuned thresholds)."""

        def __init__(self):
            self.transformations = [
                RemoveTextInsideTables(),
                # generous page-stub cutoff so large figures survive
                RemoveFullPageStubs(max_area_pct=0.75),
                CombineNodesSpatially(
                    x_error_margin=10, y_error_margin=4, criteria="both_small"
                ),
                CombineHeadingsWithClosestText(),
                CombineBullets(),
                CombineNodesSpatially(
                    x_error_margin=0, y_error_margin=10, criteria="both_small"
                ),
                RemoveMetadataElements(),
                CombineNodesSpatially(criteria="either_stub"),
                RemoveRepeatedElements(threshold=2),
                RemoveNodesBelowNTokens(min_tokens=10),
                # re-run: bullets split across pages combine only after
                # page metadata is gone
                CombineBullets(),
            ]

    class PageChunker(ProcessingStep):
        """Group node elements by their page (reference :111)."""

        def process(self, nodes: list) -> list:
            elements_by_page: dict[int, list] = {}
            for node in nodes:
                for element in node.elements:
                    elements_by_page.setdefault(element.page, []).append(element)
            return [Node(elements=tuple(elems)) for elems in elements_by_page.values()]

    class SamePageIngestionPipeline(IngestionPipeline):
        """One chunk per page (reference :139)."""

        def __init__(self, additional_transformations: list | None = None):
            self.transformations = [PageChunker()] + list(
                additional_transformations or []
            )

    def _table_args_dict_to_model(args_dict: dict) -> Any:
        algorithm = args_dict.get("parsing_algorithm")
        if algorithm == "table-transformers":
            return tables.TableTransformersArgs(**args_dict)
        if algorithm == "pymupdf":
            return tables.PyMuPDFArgs(**args_dict)
        if algorithm == "unitable":
            return tables.UnitableArgs(**args_dict)
        if algorithm == "llm":
            return LLMArgs(**args_dict)
        raise ValueError(f"Unsupported parsing_algorithm: {algorithm}")

    def _cropped_table_images(doc: Pdf, min_confidence: float):
        """Detect table bboxes on every page and crop them to b64 images
        (shared scaffold of the llm table ingestor, reference :162-217)."""
        try:
            from openparse.tables.table_transformers.ml import find_table_bboxes
            from openparse.tables.utils import (
                adjust_bbox_with_padding,
                crop_img_with_padding,
                doc_to_imgs,
            )
        except ImportError as e:
            raise ImportError(
                "Table detection requires the `torch`, `torchvision` and "
                "`transformers` libraries to be installed."
            ) from e
        from ._parser_utils import img_to_b64

        pdoc = doc.to_pymupdf_doc()
        pdf_as_imgs = doc_to_imgs(pdoc)
        image_ls: list[str] = []
        bbox_ls: list = []
        for page_num, img in enumerate(pdf_as_imgs):
            page = pdoc[page_num]
            for table_bbox in find_table_bboxes(img, min_confidence):
                padded = adjust_bbox_with_padding(
                    bbox=table_bbox.bbox,
                    page_width=page.rect.width,
                    page_height=page.rect.height,
                    padding_pct=0.05,
                )
                image_ls.append(
                    img_to_b64(crop_img_with_padding(pdf_as_imgs[page_num], padded))
                )
                bbox_ls.append(
                    Bbox(
                        page=page_num,
                        x0=padded[0],
                        y0=page.rect.height - padded[3],
                        x1=padded[2],
                        y1=page.rect.height - padded[1],
                        page_width=page.rect.width,
                        page_height=page.rect.height,
                    )
                )
        return image_ls, bbox_ls

    def _parse_cropped(image_ls, bbox_ls, args: LLMArgs) -> list:
        logger.info("OpenParse extracted %d regions; parsing...", len(image_ls))
        results = _run_async(
            parse_image_list(image_ls, args.llm, args.prompt, args.llm_model)
        )
        return [
            TableElement(bbox=bbox, text=text_)
            for bbox, text_ in zip(bbox_ls, results)
        ]

    def _ingest_with_llm(doc: Pdf, args: LLMArgs, verbose: bool = False) -> list:
        """Vision-LLM table extraction (reference :162)."""
        image_ls, bbox_ls = _cropped_table_images(doc, args.min_table_confidence)
        return _parse_cropped(image_ls, bbox_ls, args)

    def _ingest_images_with_llm(doc: Pdf, args: LLMArgs, verbose: bool = False) -> list:
        """Figure extraction via surya layout detection, described by the
        vision LLM (reference :236)."""
        try:
            from openparse.tables.utils import (
                adjust_bbox_with_padding,
                doc_to_imgs,
            )
            from surya.detection import batch_text_detection
            from surya.layout import batch_layout_detection
            from surya.model.detection.segformer import load_model, load_processor
            from surya.settings import settings
        except ImportError as e:
            raise ImportError(
                "Image extraction requires the `surya-ocr` local vision stack."
            ) from e
        from ._parser_utils import img_to_b64

        pdoc = doc.to_pymupdf_doc()
        pdf_as_imgs = doc_to_imgs(pdoc)
        model = load_model(checkpoint=settings.LAYOUT_MODEL_CHECKPOINT)
        processor = load_processor(checkpoint=settings.LAYOUT_MODEL_CHECKPOINT)
        det_model = load_model()
        det_processor = load_processor()
        line_predictions = batch_text_detection(pdf_as_imgs, det_model, det_processor)
        layout_predictions = batch_layout_detection(
            pdf_as_imgs, model, processor, line_predictions
        )
        image_ls, bbox_ls = [], []
        for page_num, layout in enumerate(layout_predictions):
            page = pdoc[page_num]
            for element in layout.bboxes:
                if element.label != "Figure":
                    continue
                image_ls.append(img_to_b64(pdf_as_imgs[page_num].crop(element.bbox)))
                padded = adjust_bbox_with_padding(
                    bbox=element.bbox,
                    page_width=page.rect.width,
                    page_height=page.rect.height,
                    padding_pct=0.05,
                )
                bbox_ls.append(
                    Bbox(
                        page=page_num,
                        x0=padded[0],
                        y0=page.rect.height - padded[3],
                        x1=padded[2],
                        y1=page.rect.height - padded[1],
                        page_width=page.rect.width,
                        page_height=page.rect.height,
                    )
                )
        return _parse_cropped(image_ls, bbox_ls, args)

    def ingest(doc: Pdf, parsing_args: Any = None, verbose: bool = False) -> list:
        """Dispatch table extraction by args type (reference :323)."""
        from openparse.tables.parse import (
            PyMuPDFArgs,
            TableTransformersArgs,
            UnitableArgs,
            _ingest_with_pymupdf,
            _ingest_with_table_transformers,
            _ingest_with_unitable,
        )

        if isinstance(parsing_args, TableTransformersArgs):
            return _ingest_with_table_transformers(doc, parsing_args, verbose)
        if isinstance(parsing_args, PyMuPDFArgs):
            return _ingest_with_pymupdf(doc, parsing_args, verbose)
        if isinstance(parsing_args, UnitableArgs):
            return _ingest_with_unitable(doc, parsing_args, verbose)
        if isinstance(parsing_args, LLMArgs):
            return _ingest_with_llm(doc, parsing_args, verbose)
        raise ValueError("Unsupported parsing_algorithm.")

    class PyMuDocumentParser(DocumentParser):
        """pymupdf text ingestion + table/image extraction + processing
        pipeline -> ParsedDocument (reference :343)."""

        def __init__(
            self,
            *,
            processing_pipeline=None,
            table_args: dict | None = None,
            image_args: dict | None = None,
        ):
            super().__init__(
                processing_pipeline=processing_pipeline, table_args=table_args
            )
            self.image_args = image_args

        def parse(self, doc: openparse.Pdf) -> ParsedDocument:
            text_elems = text.ingest(doc, parsing_method="pymupdf")
            text_nodes = self._elems_to_nodes(text_elems)

            image_nodes = []
            if self.image_args:
                image_args_obj = _table_args_dict_to_model(self.image_args)
                assert isinstance(
                    image_args_obj, LLMArgs
                ), "Image extractor expects `LLMArgs` for parsing arguments."
                image_nodes = self._elems_to_nodes(
                    _ingest_images_with_llm(doc, image_args_obj)
                )

            table_nodes = []
            table_args_obj = None
            if self.table_args:
                table_args_obj = _table_args_dict_to_model(self.table_args)
                table_nodes = self._elems_to_nodes(
                    ingest(doc, table_args_obj, verbose=self._verbose)
                )

            logger.info(
                "OpenParse parsed PDF: %d text, %d table, %d image nodes",
                len(text_nodes),
                len(table_nodes),
                len(image_nodes),
            )
            nodes = self.processing_pipeline.run(
                text_nodes + table_nodes + image_nodes
            )
            logger.info("Nodes after processing pipeline: %d", len(nodes))
            return ParsedDocument(
                nodes=nodes,
                filename="<bytes>",
                num_pages=doc.num_pages,
                coordinate_system=consts.COORDINATE_SYSTEM,
                table_parsing_kwargs=(
                    table_args_obj.model_dump() if table_args_obj else None
                ),
                creation_date=doc.file_metadata.get("creation_date"),
                last_modified_date=doc.file_metadata.get("last_modified_date"),
                last_accessed_date=doc.file_metadata.get("last_accessed_date"),
                file_size=doc.file_metadata.get("file_size"),
            )

    return {
        "SimpleIngestionPipeline": SimpleIngestionPipeline,
        "PageChunker": PageChunker,
        "SamePageIngestionPipeline": SamePageIngestionPipeline,
        "PyMuDocumentParser": PyMuDocumentParser,
        "ingest": ingest,
        "_ingest_with_llm": _ingest_with_llm,
        "_ingest_images_with_llm": _ingest_images_with_llm,
        "_table_args_dict_to_model": _table_args_dict_to_model,
    }


def __getattr__(name: str):
    if name == "LLMArgs":
        return _llm_args()
    if name in _LAZY_NAMES:
        try:
            built = _build_lazy()
        except ImportError as e:
            raise ImportError(
                f"{name} requires the 'openparse' package (and its pdf "
                "stack); install it to use openparse ingestion pipelines"
            ) from e
        globals().update(built)
        return globals()[name]
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY_NAMES) | {"LLMArgs"})


__all__ = ["LLMArgs", "parse_image_list", *_LAZY_NAMES]
