"""Every kernel entry of the port (``kernels/*/ops.py``) on ``meta``
against its plain version on the CPU: the same output shapes and dtypes,
with no launch and no plain call on ``meta``; the backward of the bag's,
the row gather's and the segment sum's autograd nodes on ``meta`` too. The
work each entry records under a cost counter is its ``kernels/cost.py``
formula, as one op (nothing its plain version runs inside is counted),
with the data-dependent part on the CPU and without it on ``meta``. And
the main path's bounds, from those formulas at the main path's shapes,
read PERF.md section 6's bound column to its printed digits."""
import pytest
import torch

from repro_torch.analysis import hlo_cost
from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.core import heavy_hitter as thh
from repro_torch.core import pipeline
from repro_torch.kernels import cost, counts
from repro_torch.kernels.admit import ops as admit_ops
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.bag import ops as bag_ops
from repro_torch.kernels.bag import ref as bag_ref
from repro_torch.kernels.heavy_hitter import ops as hh_ops
from repro_torch.kernels.heavy_hitter.heavy_hitter import MAX_BMAX, update_plan
from repro_torch.kernels.mips import ops as mips_ops
from repro_torch.kernels.prefilter import ops as prefilter_ops
from repro_torch.kernels.rerank import ops as rerank_ops
from repro_torch.kernels.serve import ops as serve_ops
from repro_torch.store import quant


def _inputs():
    g = torch.Generator().manual_seed(0)
    B, d, K, n, Q, C, depth = 16, 8, 5, 3, 4, 6, 4
    rows = torch.randn((C * depth, d), generator=g)
    embs, scales = quant.quantize_int8(rows / rows.norm(dim=1, keepdim=True), dim=-1)
    live = torch.rand((B,), generator=g) < 0.8
    V, L, bags = 10, 12, 3
    idx = torch.randint(0, V, (L,), generator=g, dtype=torch.int32)
    seg = torch.sort(torch.randint(0, bags, (L,), generator=g, dtype=torch.int32)).values
    out = dict(
        x=torch.randn((B, d), generator=g), basis=torch.randn((n, d), generator=g),
        cent=torch.randn((K, d), generator=g), live=live,
        q=torch.randn((Q, d), generator=g), index=torch.randn((K, d), generator=g),
        valid=torch.tensor([True, False, True, True, True]),
        labels=torch.tensor([2, -1, 0, 5, 3], dtype=torch.int32),
        embs=embs.view(C, depth, d), scales=scales.view(C, depth),
        ring_ids=torch.where(torch.rand((C, depth), generator=g) < 0.6,
                             torch.arange(C * depth, dtype=torch.int32).view(C, depth), -1),
        routes=torch.tensor([[0, 1], [2, 2], [-1, 5], [3, 4]], dtype=torch.int32),
        table=torch.randn((V, d), generator=g), idx=idx, seg=seg, bags=bags,
        w=torch.rand((L,), generator=g), grad=torch.randn((bags, d), generator=g),
        ids=torch.randint(0, V, (2, 3), generator=g, dtype=torch.int32),
        gids=torch.randn((2, 3, d), generator=g),
        data=torch.randn((L, d), generator=g))
    # the orders a caller makes once (counted before each case's reset)
    out["seg_order"] = bag_ref.segment_order_ref(seg, 5)
    out["ids_order"] = bag_ref.segment_order_ref(out["ids"], V)
    return out


def _hh(capacity=8):
    cfg = thh.HHConfig(capacity=capacity, policy=thh.Policy.RANDOM_EVICT)
    labels = torch.tensor([0, 1, 2, 3, 4, -1, 5, 6, 7, 8, 9, 1], dtype=torch.int32)
    draws = thh.draw(cfg, labels.shape[0], torch.Generator().manual_seed(0), "cpu")
    return cfg, thh.init(cfg, "cpu"), labels, draws


def _to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


# (entry name in counts / cost, call on a dict of inputs, the formula)
ENTRIES = {
    "admit_int8": ("admit", lambda i: admit_ops.admit(
        i["x"], i["basis"], i["cent"], 0.1, i["live"], store_dtype="int8"),
        lambda i, out: cost.admit(16, 8, 5, 3, True)),
    "admit_fp32_live_none": ("admit", lambda i: admit_ops.admit(
        i["x"], i["basis"], i["cent"], 0.1, None),
        lambda i, out: cost.admit(16, 8, 5, 3, False, live=False)),
    "admit_no_rows": ("admit", lambda i: admit_ops.admit(
        i["x"], i["basis"], i["cent"], 0.1, i["live"], emit_rows=False),
        lambda i, out: cost.admit(16, 8, 5, 3, False, emit_rows=False)),
    "assign": ("assign", lambda i: assign_ops.assign(i["x"], i["cent"]),
               lambda i, out: cost.assign(16, 5, 8)),
    "mips": ("mips", lambda i: mips_ops.mips_topk(i["q"], i["index"], i["valid"], 3),
             lambda i, out: cost.mips(4, 5, 8, 3)),
    "prefilter": ("prefilter", lambda i: prefilter_ops.prefilter_scores(i["x"], i["basis"]),
                  lambda i, out: cost.prefilter(16, 3, 8)),
    "rerank": ("rerank", lambda i: rerank_ops.rerank_topk(
        i["q"], i["embs"], i["ring_ids"], i["routes"], 3, scales=i["scales"]),
        lambda i, out: cost.rerank(4, 8, 2, 4, 3, 1, True, cost.distinct(i["routes"]))),
    "serve": ("serve", lambda i: serve_ops.serve_topk(
        i["q"], i["q"], i["index"], i["valid"], i["labels"], i["embs"], i["ring_ids"], 3, 2,
        scales=i["scales"]),
        lambda i, out: cost.serve(4, 8, 5, 4, 2, 3, 1, True, cost.distinct(out[2]))),
    "serve_route": ("serve_route", lambda i: serve_ops.serve_routes(
        i["q"], i["index"], i["valid"], i["labels"], 2),
        lambda i, out: cost.serve_route(4, 8, 5, 2)),
    "bag": ("bag", lambda i: bag_ops.embedding_bag(
        i["table"], i["idx"], i["seg"], i["bags"], i["w"], "mean"),
        lambda i, out: cost.bag(12, 8, 3, 4, cost.distinct(i["idx"]))),
    "bag_sorted": ("bag", lambda i: bag_ops.embedding_bag_sorted(
        i["table"], i["idx"], i["seg"], i["bags"], None, "sum"),
        lambda i, out: cost.bag(12, 8, 3, 4, cost.distinct(i["idx"]))),
    "bag_backward": ("bag_backward", lambda i: bag_ops.embedding_bag_backward(
        i["table"], i["idx"], i["seg"], i["bags"], i["grad"], i["w"], "mean"),
        lambda i, out: cost.bag_backward(10, 8, 12, 3, 4, 4, 4, True)),
    "bag_backward_d_w": ("bag_backward", lambda i: bag_ops.embedding_bag_backward(
        i["table"], i["idx"], i["seg"], i["bags"], i["grad"], i["w"], "sum",
        weights_grad=True),
        lambda i, out: cost.bag_backward(10, 8, 12, 3, 4, 4, 4, True, True,
                                         cost.distinct(i["idx"]))),
    "gather_backward": ("gather_backward", lambda i: bag_ops.gather_backward(
        i["table"], i["ids"], i["gids"]),
        lambda i, out: cost.gather_backward(10, 8, 6, 4, 4)),
    "segment_sum": ("segment_sum", lambda i: bag_ops.segment_sum(i["data"], i["seg"], 5),
                    lambda i, out: cost.segment_sum(12, 8, 5, 4, 4)),
    "segment_sum_ordered": ("segment_sum", lambda i: bag_ops.segment_sum(
        i["data"], i["seg"], 5, order=i["seg_order"]),
        lambda i, out: cost.segment_sum(12, 8, 5, 4, 4)),
    "gather_backward_ordered": ("gather_backward", lambda i: bag_ops.gather_backward(
        i["table"], i["ids"], i["gids"], order=i["ids_order"]),
        lambda i, out: cost.gather_backward(10, 8, 6, 4, 4)),
    "segment_order": ("segment_order", lambda i: bag_ops.segment_order(i["ids"], 10),
                      lambda i, out: cost.segment_order(6, 10, 4, bag_ref.order_splits(10, 6))),
}


def _shapes(tree):
    return [(tuple(t.shape), t.dtype) if torch.is_tensor(t) else t
            for t in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _run(name, call, dev):
    counts.reset_all()
    with hlo_cost.OpCounter() as c:
        out = call()
    return out, c, counts.snapshot()


@pytest.mark.parametrize("case", [*ENTRIES, "heavy_hitter", "heavy_hitter_large"])
def test_entry_on_meta_has_the_plain_shapes_and_records_its_formula(case):
    if case.startswith("heavy_hitter"):
        # "heavy_hitter_large": a bmax past the one-block kernel, which the
        # card's large path takes; the same function, the same formula
        name = "heavy_hitter"
        bmax = 8 if case == "heavy_hitter" else MAX_BMAX + 1
        assert update_plan(bmax, 0, gumbel=True).path == ("block" if bmax == 8 else "large")
        cfg, state, labels, draws = _hh(bmax)
        call = lambda i: hh_ops.update_batch(cfg, i["state"], i["labels"], i["draws"])  # noqa
        inputs = {"state": state, "labels": labels, "draws": draws}

        def formula(i, out):
            ev = 0 if i["labels"].is_meta else \
                int(out[0].total_evictions) - int(i["state"].total_evictions)
            return cost.heavy_hitter(12, bmax, 0, False, True, ev)
    else:
        name, call, formula = ENTRIES[case]
        inputs = _inputs()
    out_cpu, c_cpu, n_cpu = _run(name, lambda: call(inputs), "cpu")
    meta_in = _to(inputs, "meta")
    out_meta, c_meta, n_meta = _run(name, lambda: call(meta_in), "meta")
    assert _shapes(out_meta) == _shapes(out_cpu)
    assert all(t.is_meta for t in _leaves(out_meta) if torch.is_tensor(t))
    assert n_cpu[name] == {"kernel": 0, "plain": 1}
    assert all(v == {"kernel": 0, "plain": 0} for v in n_meta.values()), n_meta
    for c, out, i in ((c_cpu, out_cpu, inputs), (c_meta, out_meta, meta_in)):
        w = formula(i, out)
        assert list(c.by_op) == [(f"kernel.{name}", hlo_cost.shape_str(_leaves(out)[0]))]
        assert (c.flops, c.bytes) == (w.flops, w.bytes)
        assert c.flops_by_dtype == ({"float32": w.flops} if w.flops else {})
    # the data-dependent part is the CPU's alone, and only adds
    assert c_meta.bytes <= c_cpu.bytes and c_meta.flops == c_cpu.flops


@pytest.mark.parametrize("case", ["bag", "gather", "segment_sum", "gather_ordered",
                                  "segment_sum_ordered"])
def test_autograd_nodes_run_backward_on_meta(case):
    i = _inputs()
    for dev in ("cpu", "meta"):
        counts.reset_all()
        if case.endswith("_ordered"):
            t = i["data" if case.startswith("segment") else "table"].to(dev)
            t.requires_grad_(True)
            if case.startswith("segment"):
                out = bag_ops.segment_sum(t, i["seg"].to(dev), 5, order=_to(i["seg_order"], dev))
                names = ("segment_sum",)
            else:
                out = bag_ops.gather_rows(t, i["ids"].to(dev), order=_to(i["ids_order"], dev))
                names = ("gather_backward",)
        elif case == "bag":
            t = i["table"].to(dev).requires_grad_(True)
            out = bag_ops.embedding_bag(t, i["idx"].to(dev), i["seg"].to(dev), 3,
                                        i["w"].to(dev), "mean")
            names = ("bag", "bag_backward")
        elif case == "gather":
            t = i["table"].to(dev).requires_grad_(True)
            out = bag_ops.gather_rows(t, i["ids"].to(dev))
            names = ("gather_backward",)
        else:
            t = i["data"].to(dev).requires_grad_(True)
            out = bag_ops.segment_sum(t, i["seg"].to(dev), 5)
            names = ("segment_sum",)
        (g,) = torch.autograd.grad(out.sum(), t)
        assert g.shape == t.shape and g.dtype == t.dtype and g.device.type == dev
        snap = counts.snapshot()
        want = {"kernel": 0, "plain": 1 if dev == "cpu" else 0}
        assert all(snap[n] == want for n in names), snap


def test_main_path_bounds_read_perf_md():
    """PERF.md section 6's bound column at the main path's shapes (k = B =
    4218 at 150 MB, d = 384, 256-document batches, 64 queries, nprobe 8,
    top-10; MIND's train shape; minibatch_lg's padded aggregation). Serve,
    rerank and the bag read the distinct rings or rows the card's data
    routed to; their data-free part lies under the printed bound."""
    cfg = pipeline.budget_to_config(150.0, dim=384, base=paper_pipeline_config(
        dim=384, store_depth=64, store_dtype="int8"))
    K, n, bmax = cfg.clus.num_clusters, cfg.pre.num_vectors, cfg.hh.bmax()
    assert (K, bmax, cfg.hh.policy) == (4218, 4218, thh.Policy.MIN_EVICT)

    def printed(work, digits):
        ms, by = cost.bound(work)
        return round(ms, digits), by

    assert printed(cost.admit(256, 384, K, n, True), 4) == (0.0124, "operations")
    assert printed(cost.mips(64, K, 384, 10), 4) == (0.0031, "operations")
    assert printed(cost.serve_route(64, 384, K, 8), 4) == (0.0031, "operations")
    assert printed(cost.prefilter(256, n, 384), 4) == (0.0001, "bytes")
    assert printed(cost.assign(256, K, 384), 4) == (0.0125, "operations")
    assert printed(cost.mips(4, 10**6, 64, 100), 4) == (0.0767, "bytes")
    assert printed(cost.mips(1, 10**6, 18, 100), 4) == (0.0218, "bytes")
    assert printed(cost.mips(1, 10**6, 11, 100), 4) == (0.0134, "bytes")
    assert printed(cost.heavy_hitter(256, bmax, 0, False, False), 6) == (0.000022, "bytes")
    # the 1 GB budget's counter (row 8b, the large path) and mips over its
    # 28,125 prototypes; the staged route's k = nprobe
    big = pipeline.budget_to_config(1000.0, dim=384, base=paper_pipeline_config(
        dim=384, store_depth=64, store_dtype="int8")).hh.bmax()
    assert big == 28_125
    assert printed(cost.heavy_hitter(256, big, 0, False, False), 6) == (0.000136, "bytes")
    assert printed(cost.mips(64, big, 384, 10), 4) == (0.0206, "operations")
    assert printed(cost.mips(64, K, 384, 8), 4) == (0.0031, "operations")
    L = 65_536 * 50
    assert printed(cost.bag_backward(10**6, 64, L, 65_536, 4, 4, 4, True), 4) == \
        (0.0932, "bytes")
    assert printed(cost.gather_backward(10**6, 64, L, 4, 4), 4) == (0.3307, "bytes")
    assert printed(cost.gather_backward(10**6, 64, 65_536, 4, 4), 4) == (0.0815, "bytes")
    assert printed(cost.gather_backward(10**6, 64, 512, 4, 4), 4) == (0.0765, "bytes")
    assert printed(cost.segment_sum(168_960, 128, 169_984, 4, 4), 4) == (0.0520, "bytes")
    assert cost.bound(cost.serve(64, 384, K, 64, 8, 10, 1, True))[0] < 0.0037
    assert cost.bound(cost.rerank(64, 384, 8, 64, 10, 1, True))[0] < 0.0016
    assert cost.bound(cost.bag(512 * 50, 64, 512, 4))[0] < 0.0004
    assert cost.bound(cost.bag(262_144 * 50, 64, 262_144, 4))[0] < 0.0884
