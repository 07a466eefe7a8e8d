"""Demo: tumbling-window aggregation over a streaming source.

The groupby is windowed, so the verifier's unbounded-state rule
(PWL002) stays quiet: state per window is dropped once the window
closes.
"""

import pathway_tpu_torch as pw

events = pw.demo.range_stream(nb_rows=30, input_rate=1000.0)

stats = events.windowby(
    pw.this.value,
    window=pw.temporal.tumbling(duration=10),
).reduce(
    window_start=pw.this._pw_window_start,
    n=pw.reducers.count(),
    total=pw.reducers.sum(pw.this.value),
)

pw.io.null.write(stats)

if __name__ == "__main__":
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
