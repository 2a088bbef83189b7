"""The system under test: the port's ``AsyncServer`` over its ``Engine``,
built from a deployment file, and its final state read back for the
check. The only module of the benchmark that imports the program."""
from __future__ import annotations

import numpy as np
import torch


def build(cfg: dict, seed: int, warm: torch.Tensor, device: str):
    """(server, pipeline config): the deployment as the program runs it."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.core import heavy_hitter, pipeline
    from repro_torch.engine.engine import Engine
    from repro_torch.serve.runtime import AsyncServer, ServerConfig

    p, s = cfg["pipeline"], cfg["server"]
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
    scfg = ServerConfig(max_batch=int(s["max_batch"]),
                        max_wait_ms=float(s["max_wait_ms"]),
                        topk=int(s["topk"]), two_stage=True,
                        nprobe=int(s["nprobe"]))
    server = AsyncServer(pcfg, scfg, engine=engine,
                         publish_every=int(s["publish_every"]),
                         queue_max=int(s["queue_max"]))
    return server, pcfg


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
