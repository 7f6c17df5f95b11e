from spn4cir_tpu_torch.serve.service import (
    BatchingRetrievalService,
    RetrievalService,
    serve,
)
from spn4cir_tpu_torch.serve.sharded import (
    ShardedBatchingRetrievalService,
    ShardedGalleryIndex,
    ShardedRetrievalService,
)

__all__ = ["BatchingRetrievalService", "RetrievalService",
           "ShardedBatchingRetrievalService", "ShardedGalleryIndex",
           "ShardedRetrievalService", "serve"]
