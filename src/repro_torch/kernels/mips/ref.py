"""Plain PyTorch version of the ``mips`` kernel: exact top-k
inner-product search over the valid rows of an index."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF, rowwise_dots, stable_topk
from repro_torch.kernels.counts import COUNTS


def mips_topk_ref(q: torch.Tensor, index: torch.Tensor, valid: torch.Tensor,
                  k: int):
    """q [Q, d], index [N, d], valid [N] bool -> (scores [Q, k] f32
    descending, ids [Q, k] i32); invalid rows score NEG_INF; ties go to
    the lowest row."""
    COUNTS["mips"].plain += 1
    s = rowwise_dots(q, index)   # a query's scores do not depend on Q
    s = torch.where(valid[None, :], s, NEG_INF)
    scores, ids = stable_topk(s, k)
    return scores, ids.to(torch.int32)
