"""Synthetic data of the port (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import (TokenPipeline, movielens_like_ratings,
                                       shard_batch, synthetic_ratings)

__all__ = ["TokenPipeline", "movielens_like_ratings", "shard_batch",
           "synthetic_ratings"]
