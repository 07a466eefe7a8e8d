"""Classification dataset loaders.

Rebuild of upstream Pathway's python/pathway/stdlib/ml/datasets/
classification (load_mnist_sample :12 — which fetches OpenML MNIST).
This build has no network egress: pass a local path to the cached
``mnist.npz``, or use ``synthetic=True`` for a deterministic stand-in
with the same schema (data: ndarray[784], label: str)."""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnDefinition, schema_builder


def load_mnist_sample(
    sample_size: int = 70000,
    *,
    path: str | None = None,
    synthetic: bool = False,
    with_labels: bool = True,
):
    """Return (train_table, test_table) of flattened digit images, 10%
    held out, matching the reference loader's shape."""
    if synthetic:
        rng = np.random.default_rng(0)
        images = rng.integers(0, 255, (sample_size, 784)).astype(np.float64)
        labels = rng.integers(0, 10, sample_size)
    elif path is not None:
        with np.load(path) as z:
            images = z["x_train"].reshape(-1, 784).astype(np.float64)
            labels = z["y_train"] if with_labels else np.zeros(len(images), np.int64)
        images, labels = images[:sample_size], labels[:sample_size]
    else:
        raise NotImplementedError(
            "load_mnist_sample: network fetch (OpenML) is unavailable in "
            "this build; pass path='mnist.npz' or synthetic=True"
        )
    n = len(images)
    split = n - n // 10
    cols = {"data": ColumnDefinition(dtype=dt.ANY)}
    if with_labels:
        cols["label"] = ColumnDefinition(dtype=dt.STR)
    schema = schema_builder(dict(cols), name="MnistSchema")

    def build(imgs, labs):
        from pathway_tpu_torch.debug import table_from_rows

        rows = [
            (img,) + ((str(lab),) if with_labels else ())
            for img, lab in zip(imgs, labs)
        ]
        return table_from_rows(schema, rows)

    return build(images[:split], labels[:split]), build(images[split:], labels[split:])


__all__ = ["load_mnist_sample"]
