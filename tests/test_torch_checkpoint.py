"""``repro_torch.train.checkpoint`` against the reference's
``train/checkpoint.py``: the keystr leaf names of a pipeline state (the
reference's typed PRNG key ``.rng`` is the port's generator ``.gen``),
host ints out as 0-d arrays and back as ints, the generator's state round
trip, and ``CheckpointManager``'s atomic save/restore and retention."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as jpipe
from repro.train import checkpoint as jckpt
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import pipeline
from repro_torch.data.streams import make_stream
from repro_torch.engine.engine import Engine
from repro_torch.train import checkpoint as ckpt

DIM = 16
KW = dict(dim=DIM, k=8, capacity=8, store_depth=4, update_interval=16)


def test_flatten_tree_names_match_reference():
    jstate = jpipe.init(j_config(**KW), jax.random.key(0))
    tstate = pipeline.init(t_config(**KW), 0, device="cpu")
    want = set(jckpt.flatten_tree(jstate)) - {".rng"}
    got = ckpt.flatten_tree(tstate)
    assert set(got) - {".gen"} == want
    for path in (".clus.centroids", ".store.embs", ".store.ptr", ".rep_ids",
                 ".clus.counts", ".hh.labels", ".arrivals"):
        assert path in got
    # nested dicts, tuples and lists take the reference's keystr form
    tree = {"w": (torch.zeros(1), [torch.ones(2), 3])}
    assert list(ckpt.flatten_tree(tree)) == list(jckpt.flatten_tree(
        {"w": (jnp.zeros(1), [jnp.ones(2), 3])}))


def test_host_ints_and_generator_round_trip():
    cfg = t_config(**KW)
    eng = Engine(cfg, 3, device="cpu")
    stream = make_stream("iot", dim=DIM)
    for _ in range(3):
        b = stream.next_batch(16)
        eng.ingest(b["embedding"], b["doc_id"])
    flat = ckpt.flatten_tree(eng.state)
    assert flat[".arrivals"].shape == () and flat[".arrivals"] == 48
    assert flat[".gen"].dtype == torch.uint8
    arrays = {k: ckpt.to_host(v) for k, v in flat.items()}
    fresh = pipeline.init(cfg, 99, device="cpu")
    back = ckpt.unflatten_arrays(fresh, arrays)
    assert isinstance(back.arrivals, int) and back.arrivals == 48
    assert isinstance(back.upserts, int) and isinstance(back.since_upsert, int)
    assert isinstance(back.pre.fill, int) and isinstance(back.index.version, int)
    assert back.gen is not eng.state.gen
    # the restored generator continues the saved one's draws exactly
    a = torch.rand(5, generator=eng.state.gen)
    b = torch.rand(5, generator=back.gen)
    assert torch.equal(a, b)
    for key, v in ckpt.flatten_tree(back).items():
        if key != ".gen":
            np.testing.assert_array_equal(ckpt.to_host(v), arrays[key],
                                          err_msg=key)
    with pytest.raises(KeyError, match="missing"):
        ckpt.unflatten_arrays(fresh, {k: v for k, v in arrays.items()
                                      if k != ".rep_ids"})


def test_checkpoint_manager_atomic_async_and_retention(tmp_path):
    cfg = t_config(**KW)
    eng = Engine(cfg, 0, device="cpu")
    stream = make_stream("iot", dim=DIM)
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_n=2)
    states = {}
    for step in range(4):
        b = stream.next_batch(16)
        eng.ingest(b["embedding"], b["doc_id"])
        states[step] = {k: ckpt.to_host(v) for k, v in
                        ckpt.flatten_tree(eng.state).items()}
        mgr.save_async(step, eng.state, metadata={"offset": step})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]
    back, meta = mgr.restore(pipeline.init(cfg, 5, device="cpu"))
    assert meta == {"offset": 3, "step": 3}
    for key, v in ckpt.flatten_tree(back).items():
        np.testing.assert_array_equal(ckpt.to_host(v), states[3][key],
                                      err_msg=key)
    back, _ = mgr.restore(pipeline.init(cfg, 5, device="cpu"), step=2)
    np.testing.assert_array_equal(back.store.embs.numpy(),
                                  states[2][".store.embs"])
