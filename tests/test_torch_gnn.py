"""The port's MeshGraphNet (``repro_torch/models/gnn.py``) against the JAX
reference on the CPU, from the reference's params carried across by
``convert``, on the same seeded numpy batches: at the smoke config (2
layers, d_hidden 16) on each of its four shapes, with remat on and off,
the forward and the loss, the gradients (before the optimizer) against
``jax.grad``, and one AdamW train step; the segment sum's plain version
and its autograd node against ``jax.ops.segment_sum`` (empty segments,
every id 0); ``random_csr_graph`` and ``NeighborSampler.sample`` equal to
the reference's, array for array; the reference's masked-edge test on
the port; the step specs (names, shapes, dtypes, batch axes) of every
shape; the registry's config and optimizer; the launches a train step
makes on the CPU (each one a plain version); and the train launcher on
the molecule shape.

Tolerance: the forward and the loss within 1e-5 of the largest |value|;
gradients and the params and moments after one step within 1e-4 of each
leaf's largest |value| (the packages sum in other orders: the segment
sums, the matmuls, the LayerNorm means; AdamW's first step maps g to
about g / (|g| + eps), so a gradient near zero that differs only in
rounding moves its param by a different amount, bounded by lr).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import opt_tree
from repro.models.api import get_arch as j_get_arch
from repro.models.gnn import (GNNConfig as JGNNConfig, MeshGraphNet as JMeshGraphNet,
                              NeighborSampler as JSampler,
                              random_csr_graph as j_random_csr_graph)
from repro_torch.convert import (params_from_numpy, params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import counts
from repro_torch.kernels.bag import ops as bag_ops
from repro_torch.kernels.bag.ref import segment_sum_ref
from repro_torch.models.api import get_arch
from repro_torch.models.gnn import (GNNConfig, MeshGraphNet, NeighborSampler,
                                    random_csr_graph)
from repro_torch.models.testing import dummy_batch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _np_batch(arch, shape: str, seed: int) -> dict:
    """A seeded numpy batch at ``shape``'s padded step sizes: the shape's
    own node and edge counts live (minibatch_lg: a sampled subgraph of a
    random CSR graph), the rest padding (ids 0, masks false), features
    N(0, 1), class labels uniform (molecule: one N(0, 1) target a node)."""
    rng = np.random.default_rng(seed)
    d = dict(arch.shapes[shape].dims)
    specs = arch.step(shape).input_specs
    N, E = specs["node_mask"].shape[0], specs["edge_mask"].shape[0]
    src, dst = np.zeros(E, np.int32), np.zeros(E, np.int32)
    if shape == "minibatch_lg":
        indptr, indices = random_csr_graph(d["n_nodes"], max(1, d["n_edges"] // d["n_nodes"]),
                                           seed)
        sub = NeighborSampler(indptr, indices, (d["fanout1"], d["fanout2"]), seed).sample(
            rng.choice(d["n_nodes"], d["batch_nodes"], replace=False), d["pad_nodes"],
            d["pad_edges"])
        n, e = sub["n_nodes"], sub["n_edges"]
        src[:e], dst[:e] = sub["edge_src"][:e], sub["edge_dst"][:e]
    else:
        n = d["n_nodes"] * d.get("batch", 1)
        e = d["n_edges"] * d.get("batch", 1)
        src[:e] = rng.integers(0, n, e)
        dst[:e] = rng.integers(0, n, e)
    F = d["d_feat"]
    labels = (rng.normal(size=(N, d["n_out"])).astype(np.float32) if shape == "molecule"
              else rng.integers(0, d["n_out"], N).astype(np.int32))
    return {"node_feat": rng.normal(size=(N, F)).astype(np.float32),
            "edge_src": src, "edge_dst": dst,
            "edge_feat": rng.normal(size=(E, arch.cfg.d_edge_feat)).astype(np.float32),
            "node_mask": np.arange(N) < n, "edge_mask": np.arange(E) < e,
            "labels": labels}


def _pair(remat: bool):
    ja, ta = j_get_arch("meshgraphnet", smoke=True), get_arch("meshgraphnet", smoke=True)
    ja.cfg = dataclasses.replace(ja.cfg, remat=remat)
    ta.cfg = dataclasses.replace(ta.cfg, remat=remat)
    jstate = ja.init_train_state(jax.random.key(0))
    tstate = train_state_from_numpy({"params": jax.tree.map(np.asarray, jstate.params),
                                     "opt": opt_tree(jstate.opt)})
    return ja, jstate, ta, tstate


def _close(got, want, rel, where=""):
    """Every element within ``rel`` of ``want``'s largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * scale, where


def _close_tree(got, want, rel, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _close_tree(got[k], want[k], rel, f"{where}.{k}")
    elif want is None:
        assert got is None, where
    else:
        _close(got, want, rel, where)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_loss_grads_and_one_step_match_reference(shape, remat):
    ja, jstate, ta, tstate = _pair(remat)
    nb = _np_batch(ta, shape, seed=SHAPES.index(shape) + 1)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    # the forward
    _close(ta.forward(tstate.params, tb).detach(), ja.forward(jstate.params, jb), FWD_TOL,
           "forward")
    # the loss
    j_loss, j_ex = ja.loss(jstate.params, jb)
    t_loss, t_ex = ta.loss(tstate.params, tb)
    _close(t_loss.detach(), j_loss, FWD_TOL, "loss")
    assert set(t_ex) == set(j_ex) == {"mse" if shape == "molecule" else "ce"}
    # its gradients, before any optimizer
    j_grads = jax.grad(lambda p: ja.loss(p, jb)[0])(jstate.params)
    _, _, t_grads = ta.loss_and_grads(tstate.params, tb)
    _close_tree(params_to_numpy(t_grads), jax.tree.map(np.asarray, j_grads), GRAD_TOL, "grad")
    # one AdamW step through the StepSpec
    spec = ta.step(shape)
    j_new, j_m = ja.make_train_step()(jstate, jb)
    t_new, t_m = spec.fn(tstate, tb)
    want = {"params": jax.tree.map(np.asarray, j_new.params), "opt": opt_tree(j_new.opt)}
    got = train_state_to_numpy(t_new)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    _close_tree(got["params"], want["params"], GRAD_TOL, "params")
    _close_tree(got["opt"]["mu"], want["opt"]["mu"], GRAD_TOL, "mu")
    _close_tree(got["opt"]["nu"], want["opt"]["nu"], GRAD_TOL, "nu")
    assert set(t_m) == set(j_m)
    np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]), rtol=1e-5)


def test_remat_changes_no_gradient():
    """The checkpointed layers give the same loss and gradients as the
    plain loop, bit for bit (the recompute runs the same ops)."""
    arch = get_arch("meshgraphnet", smoke=True)
    params = arch.init(0, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _np_batch(arch, "full_graph_sm", 5).items()}
    plain = arch.loss_and_grads(params, tb)
    arch.cfg = dataclasses.replace(arch.cfg, remat=True)
    again = arch.loss_and_grads(params, tb)
    assert torch.equal(plain[0], again[0])
    for a, b in zip(jax.tree.leaves(params_to_numpy(plain[2])),
                    jax.tree.leaves(params_to_numpy(again[2]))):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- segment sum
SEG_CASES = [("random", 37, 200, 8), ("empty_segments", 50, 30, 5), ("all_zero", 19, 300, 16),
             ("no_entries", 7, 0, 4), ("one_segment", 1, 64, 3)]


def _seg_case(case, S, L, d, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(L, d)).astype(np.float32)
    if case == "all_zero":
        ids = np.zeros(L, np.int32)
    elif case == "empty_segments":
        ids = rng.integers(0, S // 3, L).astype(np.int32) * 3   # 2 of 3 segments empty
    else:
        ids = rng.integers(0, S, L).astype(np.int32)
    return data, ids


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case,S,L,d", SEG_CASES)
def test_segment_sum_matches_jax(case, S, L, d, ids_dtype):
    data, ids = _seg_case(case, S, L, d)
    ids = ids.astype(ids_dtype)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                          num_segments=S))
    before = counts.COUNTS["segment_sum"].plain
    got = bag_ops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), S)
    assert counts.COUNTS["segment_sum"].plain == before + 1
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    untouched = np.ones(S, bool)
    untouched[ids] = False
    assert (got.numpy()[untouched] == 0).all()
    # its gradient: the row gather grad[ids], as jax.grad of the reference's
    g = np.random.default_rng(1).normal(size=(S, d)).astype(np.float32)
    j_grad = jax.grad(lambda x: jnp.sum(jax.ops.segment_sum(x, jnp.asarray(ids), S) * g))(
        jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_(True)
    (t_grad,) = torch.autograd.grad(bag_ops.segment_sum(x, torch.from_numpy(ids), S),
                                    x, torch.from_numpy(g))
    np.testing.assert_array_equal(t_grad.numpy(), np.asarray(j_grad))


def test_segment_sum_ref_keeps_bf16_and_float64():
    data, ids = _seg_case("random", 11, 100, 4)
    t, i = torch.from_numpy(data), torch.from_numpy(ids)
    f32 = segment_sum_ref(t, i, 11)
    bf = segment_sum_ref(t.to(torch.bfloat16), i, 11)
    assert bf.dtype == torch.bfloat16
    # summed in f32 from the bf16 rows, rounded once
    want = segment_sum_ref(t.to(torch.bfloat16).float(), i, 11).to(torch.bfloat16)
    assert torch.equal(bf, want)
    f64 = segment_sum_ref(t.double(), i, 11)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), f32.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ graph and sampler
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n,deg", [(512, 4), (3000, 12)])
def test_random_csr_graph_equals_reference(n, deg, seed):
    for a, b in zip(random_csr_graph(n, deg, seed), j_random_csr_graph(n, deg, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("fanouts,pad", [((3, 2), (96, 96)), ((15, 10), (2000, 1500)),
                                         ((5,), (40, 30))])
def test_neighbor_sampler_equals_reference(fanouts, pad, seed):
    indptr, indices = j_random_csr_graph(2000, 8, seed)
    roots = np.random.default_rng(seed).choice(2000, 8, replace=False)
    mine = NeighborSampler(indptr, indices, fanouts, seed)
    theirs = JSampler(indptr, indices, fanouts, seed)
    for _ in range(2):   # the generator goes on from one call to the next
        a, b = mine.sample(roots, *pad), theirs.sample(roots, *pad)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_neighbor_sampler_subgraph_valid():
    """The reference's sampler test on the port: ids in range, the masks
    the live counts, padding at 0."""
    indptr, indices = random_csr_graph(500, 6, seed=1)
    s = NeighborSampler(indptr, indices, (5, 3), seed=0)
    out = s.sample(np.arange(8), pad_nodes=200, pad_edges=200)
    n, e = out["n_nodes"], out["n_edges"]
    assert 8 <= n <= 200 and 0 < e <= 200
    assert out["node_mask"].sum() == n and out["edge_mask"].sum() == e
    assert (out["edge_src"][:e] < n).all() and (out["edge_dst"][:e] < n).all()
    assert (out["edge_src"][e:] == 0).all() and (out["edge_dst"][e:] == 0).all()


# ------------------------------------------------------------------ model
def test_gnn_respects_edge_mask():
    """The reference's ``test_gnn_respects_edge_mask`` on the port:
    scrambling masked-out edges changes nothing."""
    g = MeshGraphNet(GNNConfig(n_layers=2, d_hidden=8, remat=False))
    g.d_feat, g.n_out = 6, 3
    p = g.init(0, "cpu")
    rng = np.random.default_rng(2)
    N, E = 10, 20
    base = {
        "node_feat": torch.from_numpy(rng.normal(size=(N, 6)).astype(np.float32)),
        "edge_src": torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
        "edge_dst": torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
        "edge_feat": torch.from_numpy(rng.normal(size=(E, 4)).astype(np.float32)),
        "node_mask": torch.ones(N, dtype=torch.bool),
        "edge_mask": torch.from_numpy(np.arange(E) < 10),
    }
    out1 = g.forward(p, base)
    scrambled = dict(base)
    scrambled["edge_feat"] = base["edge_feat"].clone()
    scrambled["edge_feat"][10:] = 99.0
    out2 = g.forward(p, scrambled)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_step_specs_match_reference(shape, smoke):
    ta, ja = get_arch("meshgraphnet", smoke=smoke), j_get_arch("meshgraphnet", smoke=smoke)
    t, j = ta.step(shape), ja.step(shape)
    assert t.kind == j.kind == "train" and callable(t.fn)
    assert list(t.input_specs) == list(j.input_specs)
    for k, js in j.input_specs.items():
        ts = t.input_specs[k]
        assert tuple(ts.shape) == tuple(js.shape), k
        assert str(ts.dtype).replace("torch.", "") == np.dtype(js.dtype).name, k
    assert t.batch_axes == j.batch_axes
    N, E = ta.padded_sizes(shape)
    assert N % 512 == 0 and E % 512 == 0
    assert (N, E) == (t.input_specs["node_mask"].shape[0], t.input_specs["edge_mask"].shape[0])


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_params_tree_match_reference(smoke):
    """The registry's config, optimizer, shapes and superset widths are the
    reference's, and ``init`` gives its params tree, leaf for leaf in
    shape and dtype (the stacked ``processor`` included), which
    ``convert`` carries both ways unchanged."""
    from repro_torch.configs import meshgraphnet as cfg_mod

    ta, ja = get_arch("meshgraphnet", smoke=smoke), j_get_arch("meshgraphnet", smoke=smoke)
    tc, jc = vars(ta.cfg), vars(ja.cfg)
    assert {k: v for k, v in tc.items() if k != "param_dtype"} == \
        {k: v for k, v in jc.items() if k != "param_dtype"}
    assert ta.cfg.param_dtype == torch.float32 and jc["param_dtype"] == jnp.float32
    assert ta.optimizer == cfg_mod.OPT and vars(ta.optimizer) == vars(ja.optimizer)
    assert {k: (s.name, s.kind, s.dims, s.skip) for k, s in ta.shapes.items()} == \
        {k: (s.name, s.kind, s.dims, s.skip) for k, s in ja.shapes.items()}
    assert (ta.d_feat, ta.n_out) == (ja.d_feat, ja.n_out)
    if smoke:
        jp = ja.init(jax.random.key(0))
        tp = ta.init(0, "cpu")
        want = jax.tree.map(lambda a: (tuple(a.shape), np.dtype(a.dtype).name), jp)
        got = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), params_to_numpy(tp))
        assert got == want
        assert tp["processor"]["edge_mlp"]["w0"].shape == (ta.cfg.n_layers, 48, 16)
        back = params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, jp)))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_defaults_match_reference():
    t, j = MeshGraphNet(), JMeshGraphNet()
    assert (t.d_feat, t.n_out) == (j.d_feat, j.n_out) == (1433, 47)
    assert {k: v for k, v in vars(GNNConfig()).items() if k != "param_dtype"} == \
        {k: v for k, v in vars(JGNNConfig()).items() if k != "param_dtype"}


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_on_cpu(remat):
    """On the CPU every aggregation and every gathered-row gradient runs
    its plain version: a layer's segment sum once forward (and once more
    in its recompute under remat), its two row gathers' gradients once
    each; no kernel launches."""
    arch = get_arch("meshgraphnet", smoke=True)
    arch.cfg = dataclasses.replace(arch.cfg, remat=remat)
    spec = arch.step("molecule")
    state = arch.init_train_state(0, "cpu")
    batch = dummy_batch(spec.input_specs, seed=1, device="cpu")
    counts.reset_all()
    new, m = spec.fn(state, batch)
    snap = counts.snapshot()
    L = arch.cfg.n_layers
    assert snap["segment_sum"] == {"kernel": 0, "plain": L * (2 if remat else 1)}, snap
    assert snap["gather_backward"] == {"kernel": 0, "plain": 2 * L}, snap
    assert all(c == {"kernel": 0, "plain": 0} for n, c in snap.items()
               if n not in ("segment_sum", "gather_backward")), snap
    assert np.isfinite(float(m["loss"])) and int(new.opt.step) == 1


def test_launcher_trains_molecule_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    ckpt = str(tmp_path / "ckpt")

    def run(steps):
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                              "meshgraphnet", "--shape", "molecule", "--steps", str(steps),
                              "--ckpt-interval", "2", "--device", "cpu", "--ckpt-dir", ckpt],
                             env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout.splitlines()

    first = run(4)
    assert first[-1] == "final checkpoint: 4" and first[-2].startswith("step 4: loss=")
    assert np.isfinite(float(first[-2].split("loss=")[1].split()[0]))
    second = run(6)
    assert [ln.split(":")[0] for ln in second if ln.startswith("step ")] == ["step 6"]
    assert second[-1] == "final checkpoint: 6"
