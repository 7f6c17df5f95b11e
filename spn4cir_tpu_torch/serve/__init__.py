from spn4cir_tpu_torch.serve.service import (
    BatchingRetrievalService,
    RetrievalService,
    serve,
)

__all__ = ["BatchingRetrievalService", "RetrievalService", "serve"]
