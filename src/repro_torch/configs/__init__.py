"""Configs of the ported architectures (one module per --arch id) and the
paper's own (``streaming_rag``).

Importing this package registers every ported factory with
``models/api``. The LM and GNN configs wait for their models (ROADMAP
A10).
"""
from repro_torch.configs import (  # noqa: F401
    bert4rec,
    dien,
    fm,
    mind,
    streaming_rag,
)
