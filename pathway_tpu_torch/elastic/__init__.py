"""Elastic mesh plane: live grow/shrink/reshard under traffic.

The port's copy of the reference's ``elastic`` package. Three legs, one
plane:

- :mod:`.controller` — :class:`ElasticIndexHandle` (the generation-
  swapping serve-through wrapper), :func:`reshard` (chunked live
  migration with durable-generation fencing, atomic cutover,
  double-answer dedup, and rollback-on-abort), and
  :class:`ElasticController` (the watermark loop wired to the HBM
  ledger's time-to-OOM forecast and the chip ledger's stranded-time
  attribution).
- :mod:`.config` — :class:`ElasticConfig` and the
  ``pw.run(elastic=)`` / ``PATHWAY_ELASTIC`` spec plumbing.
- :mod:`.metrics` — the activity-gated registry behind the
  ``pathway_elastic_*`` /metrics series, the ``/status`` elastic
  block, and the migration-ETA hint the admission plane serves as
  ``Retry-After`` while a reshard is in flight.

Typical use::

    import pathway_tpu_torch as pw

    handle = pw.elastic.register_handle(index)   # serve through this
    pw.elastic.reshard(4)                        # live 2 -> 4 grow

or let the watermarks drive it::

    pw.run(mesh="auto", elastic="hbm_frac=0.8", persistence_config=cfg)

A reshard of an index on the CPU (``device="cpu"``, or a CPU mesh) lands
on a CPU mesh; one on the cards lands on the cards (or the device pool of
``parallel/mesh.py``) and raises, before touching anything, when fewer
are visible than the target shard count.
"""

from .config import (
    ElasticConfig,
    active_elastic,
    parse_elastic_spec,
    set_active_elastic,
    use_elastic,
)
from .controller import (
    ElasticController,
    ElasticIndexHandle,
    current_shards,
    handles,
    recover_pending_reshard,
    register_cluster,
    register_handle,
    register_persistence,
    reset_registry,
    reshard,
)
from .metrics import ELASTIC_METRICS, ElasticMetrics

__all__ = [
    "ELASTIC_METRICS",
    "ElasticConfig",
    "ElasticController",
    "ElasticIndexHandle",
    "ElasticMetrics",
    "active_elastic",
    "current_shards",
    "handles",
    "parse_elastic_spec",
    "recover_pending_reshard",
    "register_cluster",
    "register_handle",
    "register_persistence",
    "reset_registry",
    "reshard",
    "set_active_elastic",
    "use_elastic",
]
