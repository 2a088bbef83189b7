"""Configs of the ported architectures (one module per --arch id) and the
paper's own (``streaming_rag``).

Importing this package registers every ported factory with
``models/api``: every arch the reference registers.
"""
from repro_torch.configs import (  # noqa: F401
    bert4rec,
    deepseek_moe_16b,
    deepseek_v3_671b,
    dien,
    fm,
    h2o_danube_1_8b,
    h2o_danube_3_4b,
    meshgraphnet,
    mind,
    qwen2_1_5b,
    streaming_rag,
)
