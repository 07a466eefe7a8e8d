"""Demo: classic incremental word count over a static corpus."""

import pathway_tpu_torch as pw

docs = pw.debug.table_from_markdown(
    """
      | text
    1 | to be or not to be
    2 | that is the question
    3 | to be is to do
    """
)

words = docs.select(word=pw.apply_with_type(str.split, list[str], pw.this.text)).flatten(
    pw.this.word
)
counts = words.groupby(pw.this.word).reduce(
    pw.this.word, count=pw.reducers.count()
)

pw.io.null.write(counts)

if __name__ == "__main__":
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
