"""Storage plane of the port: the exact KNN index on the card (``knn``),
the IVF-PQ ANN index (``ann``, ROADMAP Queue 1 item 14) and its WAL +
snapshot durability (``durable``, with ``integrity``'s CRC-32C).

The JAX package's ORM and the RAG plane around these indexes wait for
ROADMAP Queue 1 item 16."""

from .ann import ANNIndex
from .durable import DurableANN
from .knn import AsyncSearcher, VectorIndex, topk_scores, topk_scores_plain

__all__ = ["ANNIndex", "AsyncSearcher", "DurableANN", "VectorIndex", "topk_scores",
           "topk_scores_plain"]
