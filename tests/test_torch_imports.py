"""Import hygiene of the port: importing every ``repro_torch`` module and
``chip_smoke.py``'s module-level imports loads no JAX and nothing of the
JAX package; and the entry points run on the card by default, never
silently on the CPU."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_port_and_chip_smoke_import_no_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path[:0] = [{os.path.join(ROOT, "src")!r}, {ROOT!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # its module-level imports; main() is not run
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert len(names) >= 90, names
        for name in ("repro_torch.launch.serve", "repro_torch.launch.mesh",
                     "repro_torch.distributed.collectives",
                     "repro_torch.engine.sharded", "repro_torch.core.baselines",
                     "repro_torch.core.theory", "repro_torch.data.qa",
                     "repro_torch.train.trainer", "repro_torch.train.optimizer",
                     "repro_torch.data.pipeline", "repro_torch.launch.train",
                     "repro_torch.models.layers", "repro_torch.models.flash_attention",
                     "repro_torch.models.transformer", "repro_torch.configs.streaming_rag",
                     "repro_torch.configs.lm_common", "repro_torch.configs.qwen2_1_5b",
                     "repro_torch.configs.h2o_danube_1_8b",
                     "repro_torch.configs.h2o_danube_3_4b", "repro_torch.convert",
                     "repro_torch.distributed.sharding",
                     "repro_torch.distributed.compression"):
            assert name in names, name
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_run_on_the_card_by_default():
    """Without ``device=`` the entry points take ``cuda``; where there is
    no card they raise rather than fall back to the CPU."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.core import baselines, pipeline
    from repro_torch.engine.engine import Engine
    from repro_torch.engine.sharded import ShardedEngine
    from repro_torch.launch.mesh import make_debug_mesh, make_streaming_mesh
    from repro_torch.launch.serve import main as launch_serve
    from repro_torch.models.api import get_arch
    from repro_torch.serve.server import RAGServer, ServerConfig

    cfg = paper_pipeline_config(dim=16, k=8, capacity=8)
    makers = (lambda: pipeline.init(cfg).route_labels,
              lambda: Engine(cfg).state.route_labels,
              lambda: RAGServer(cfg, ServerConfig(topk=4), seed=0).state.route_labels,
              lambda: get_arch("mind", smoke=True).init()["item_emb"],
              lambda: get_arch("streaming-rag-embedder").init()["final_norm"],
              lambda: get_arch("qwen2-1.5b").init()["final_norm"],
              lambda: get_arch("h2o-danube-1.8b").init()["final_norm"],
              lambda: get_arch("h2o-danube-3-4b").init()["final_norm"],
              lambda: ShardedEngine(cfg, make_streaming_mesh(2, 2)).shards[1].route_labels,
              lambda: make_debug_mesh((2, 2)).device(1, 1),
              lambda: make_debug_mesh((2, 2, 2), ("pod", "data", "model")).device(1, 0, 1),
              lambda: baselines.make_static_rag(16, capacity=8).init(0).index.vectors,
              lambda: baselines.make_sakr(16, k=8, capacity=8).init(0).route_labels,
              lambda: baselines.make_ivfpq(16, capacity=8, nlist=2, m=2).init(
                  0, np.ones((4, 16), np.float32)).vecs)
    for make in makers:
        if torch.cuda.is_available():
            out = make()
            assert (out if isinstance(out, torch.device) else out.device).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    if not torch.cuda.is_available():   # the launcher: no run on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve(["--batches", "1"])
    assert Engine(cfg, device="cpu").state.route_labels.device.type == "cpu"
    sharded = ShardedEngine(cfg, make_streaming_mesh(2, 2, "cpu"))
    assert {s.route_labels.device.type for s in sharded.shards} == {"cpu"}
    assert get_arch("mind", smoke=True).init(device="cpu")["item_emb"].device.type == "cpu"
    lm = get_arch("qwen2-1.5b", smoke=True)
    assert lm.init(device="cpu")["final_norm"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_cache(1, 8)
    assert lm.init_cache(1, 8, "cpu")["pos"].device.type == "cpu"


def test_unported_server_options_raise(tmp_path):
    """The serving runtime is ported (ROADMAP A6): the result cache and
    the hot set arm on the snapshot runtime, and the sync server, which
    queries live state, refuses them; durability arms on the async
    server; adaptive serving works on both."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.serve.durability import DurabilityConfig
    from repro_torch.serve.runtime import AsyncServer
    from repro_torch.serve.server import RAGServer, ServerConfig

    cfg = paper_pipeline_config(dim=16, k=8, capacity=8, store_depth=4)
    for opt in ({"cache_entries": 8}, {"hotset": True}):
        scfg = ServerConfig(topk=4, two_stage=True, nprobe=2, **opt)
        with pytest.raises(AssertionError, match="snapshot runtime"):
            RAGServer(cfg, scfg, seed=0, device="cpu")
        srv = AsyncServer(cfg, scfg, seed=0, device="cpu")
        assert srv.cache_stats()["enabled"]
        srv.close()
    srv = AsyncServer(cfg, ServerConfig(topk=4), seed=0, device="cpu",
                      durability=DurabilityConfig(checkpoint_dir=str(tmp_path)))
    assert srv.robustness_stats()["durable"]
    srv.close()
    srv = RAGServer(cfg, ServerConfig(topk=4, two_stage=True, nprobe=2,
                                      adaptive=True), seed=0, device="cpu")
    assert srv.plan_space is not None and srv._controller is not None


def test_training_entry_points_run_on_the_card_by_default(tmp_path):
    """``init_train_state``, ``abstract_train_state``, the ``Trainer`` (with
    and without a mesh) and the train launcher take ``cuda`` unless told
    otherwise; without a card they raise rather than fall back to the
    CPU."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import main as launch_train
    from repro_torch.models.api import get_arch
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = get_arch("fm", smoke=True)
    cfg = TrainerConfig(ckpt_dir=str(tmp_path))
    makers = (lambda: arch.init_train_state().params["v"],
              lambda: arch.abstract_train_state().opt.mu["v"],
              lambda: Trainer(arch, cfg).init_state().params["v"],
              lambda: Trainer(arch, cfg, mesh=make_debug_mesh((2, 2))).init_state()
              .params["v"].pieces[1, 1])
    for make in makers:
        if torch.cuda.is_available():
            out = make()
            assert (out if isinstance(out, torch.device) else out.device).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train(["--arch", "fm", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert arch.init_train_state(device="cpu").opt.step.device.type == "cpu"
    assert Trainer(arch, cfg, device="cpu").init_state().params["w"].device.type == "cpu"
