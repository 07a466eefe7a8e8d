"""Demo: the document-preparation half of a RAG pipeline — split a
static corpus into token-bounded chunks with the llm xpack splitter."""

import pathway_tpu_torch as pw
from pathway_tpu_torch.xpacks.llm import splitters

docs = pw.debug.table_from_markdown(
    """
      | doc
    1 | Pathway programs describe a dataflow graph before any row flows.
    2 | The graph is verified statically and executed incrementally.
    """
)

splitter = splitters.TokenCountSplitter(min_tokens=2, max_tokens=16)
chunks = docs.select(chunks=splitter(pw.this.doc)).flatten(pw.this.chunks)

pw.io.null.write(chunks)

if __name__ == "__main__":
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
