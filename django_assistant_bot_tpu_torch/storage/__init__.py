"""Storage plane of the port: the exact KNN index on the card (``knn``).

The JAX package's ORM, ANN and durable planes wait for ROADMAP Queue 1 item
16."""

from .knn import AsyncSearcher, VectorIndex, topk_scores, topk_scores_plain

__all__ = ["AsyncSearcher", "VectorIndex", "topk_scores", "topk_scores_plain"]
