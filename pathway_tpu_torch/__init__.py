"""pathway_tpu_torch: the PyTorch/CUDA port of pathway_tpu's device layer.

The main path of this package: host tokenizer -> ``SentenceEncoder``
(MiniLM-L6 encoder whose layers run as hand-written Hopper kernels) ->
``DeviceKnnIndex`` (a device-resident slab searched by a fused top-k
kernel). Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``. The package imports torch and numpy only.
"""

from .device import resolve_device
from .models.encoder import EncoderConfig
from .models.sentence_encoder import SentenceEncoder
from .ops.knn import DeviceKnnIndex

__all__ = ["DeviceKnnIndex", "EncoderConfig", "SentenceEncoder", "resolve_device"]
