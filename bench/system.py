"""The system under test: the port's ``AsyncServer`` over its ``Engine``,
built from a deployment file, and its final state read back for the
check. The only module of the benchmark that imports the program."""
from __future__ import annotations

import numpy as np
import torch

# the deployment file's ``server`` block: each key is the ``ServerConfig``
# field or the ``AsyncServer`` argument of the same name
CONFIG_KEYS = ("two_stage", "nprobe", "topk", "max_batch", "max_wait_ms",
               "cache_entries", "hotset", "pin_budget_mb", "hotset_capacity",
               "hotset_refresh", "hotset_min_count")
SERVER_KEYS = ("publish_every", "queue_max")
# keys the block may state only at the value the check can judge: (the
# value refused, why); absent, each takes ServerConfig's default
REFUSED = {
    "two_stage": (False, "the check judges routed two-stage answers only"),
    "adaptive": (True, "degraded and shed answers are not exact"),
    "durability": (True, "no crash happens in the window; recovery needs a "
                         "cell of its own"),
}


def server_args(s: dict) -> tuple[dict, dict]:
    """(``ServerConfig`` keywords, ``AsyncServer`` keywords) of a server
    block; raises ``ValueError`` naming the key for a key it does not know
    or one the check cannot judge."""
    from repro_torch.serve.runtime import ServerConfig

    defaults = ServerConfig()
    for key in s:
        if key not in CONFIG_KEYS + SERVER_KEYS + tuple(REFUSED):
            raise ValueError(f"server key {key!r}: the benchmark does not "
                             "know it")
    for key, (bad, why) in REFUSED.items():
        if s.get(key, getattr(defaults, key, False)) == bad:
            raise ValueError(f"server key {key!r} = {bad}: {why}")

    def typed(key, default):
        v = s[key]
        if isinstance(default, bool) and not isinstance(v, bool):
            raise ValueError(f"server key {key!r}: {v!r} is not true or false")
        return type(default)(v)

    scfg = {k: typed(k, getattr(defaults, k)) for k in CONFIG_KEYS if k in s}
    return scfg, {k: int(s[k]) for k in SERVER_KEYS if k in s}


def build(cfg: dict, seed: int, warm: torch.Tensor, device: str):
    """(server, pipeline config): the deployment as the program runs it."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.core import heavy_hitter, pipeline
    from repro_torch.engine.engine import Engine
    from repro_torch.serve.runtime import AsyncServer, ServerConfig

    scfg, sargs = server_args(cfg["server"])
    p = cfg["pipeline"]
    base = paper_pipeline_config(
        dim=int(cfg["dim"]), alpha=float(p["alpha"]),
        admit_prob=float(p["admit_prob"]), basis=p["basis"],
        policy=heavy_hitter.Policy[p["policy"]],
        update_interval=int(p["update_interval"]),
        store_depth=int(p["store_depth"]), store_dtype=p["store_dtype"])
    assert base.pre.num_vectors == int(p["num_vectors"]), p
    pcfg = pipeline.budget_to_config(float(cfg["budget_mb"]),
                                     dim=int(cfg["dim"]), base=base)
    engine = Engine(pcfg, seed, warm, device=device)
    server = AsyncServer(pcfg, ServerConfig(**scfg), engine=engine, **sargs)
    return server, pcfg


def serving_counters(server) -> dict:
    """The serving cache's counters (zeros with no cache) and the kernels'
    launch counts, read at each end of the window."""
    from repro_torch.kernels import counts

    return {"cache": server.cache_stats(), "launches": counts.snapshot()}


def final_state(server) -> dict:
    """The last published state on the host, in the form the check reads:
    live ring entries (cluster, slot, doc, stamp) with their int8 rows and
    scales, the write counters, the valid index rows, the counters."""
    st = server.engine.state
    store = st.store
    c, s = torch.nonzero(store.ids >= 0, as_tuple=True)
    entries = torch.stack([c, s, store.ids[c, s].to(torch.int64),
                           store.stamps[c, s].to(torch.int64)], dim=1)
    slots = torch.nonzero(st.index.valid).squeeze(1)
    return {
        "entries": entries.cpu().numpy().astype(np.int64),
        "rows": store.embs[c, s].cpu().numpy(),
        "scales": store.scales[c, s].cpu().numpy(),
        "ptr": store.ptr.cpu().numpy().astype(np.int64),
        "index_slots": slots.cpu().numpy().astype(np.int64),
        "index_labels": st.route_labels[slots].cpu().numpy().astype(np.int64),
        "index_ids": st.index.ids[slots].cpu().numpy().astype(np.int64),
        "index_vecs": st.index.vectors[slots].cpu().numpy(),
        "counters": server.engine.device_counters(),
    }
