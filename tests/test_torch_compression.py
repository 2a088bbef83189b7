"""The port's int8 all-reduce with error feedback, its hierarchical psum and
``shard_batch``, against the JAX reference.

The reference's collectives run inside ``shard_map``; here they run under
``jax.vmap(..., axis_name=...)`` on one CPU device (the same collectives
over a vmapped axis), fed the same numpy parts as the port's per-shard
lists. Rules: the int8 payloads equal, except an entry off by one where
``y / scale`` lies within 1e-4 of a half-integer (the two packages may
round a division there to different sides); scales bit-equal (the same
fp32 max and division); totals and the new residuals within rtol 1e-5 of
the largest |value| (the packages sum the shards in other orders).
``hierarchical_psum`` within rtol 1e-5 of the largest |value|.
``shard_batch``'s pieces are each data shard's rows, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as j_coll
from repro.distributed import compression as j_comp
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import collectives as t_coll
from repro_torch.distributed import compression as t_comp
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import make_debug_mesh

CPU = torch.device("cpu")


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _payloads_agree(q_port, q_ref, y, scale):
    """Equal, or off by one only where y / scale is within 1e-4 of a
    half-integer."""
    q_port, q_ref = np.asarray(q_port, np.int32), np.asarray(q_ref, np.int32)
    off = q_port != q_ref
    if off.any():
        r = np.asarray(y, np.float64)[off] / float(scale)
        assert np.all(np.abs(q_port - q_ref)[off] == 1)
        assert np.all(np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-4)
    return int(off.sum())


def _ref_psum(xs, es):
    return jax.vmap(lambda x, e: j_comp.compressed_psum(x, "data", e),
                    axis_name="data")(jnp.asarray(xs), jnp.asarray(es))


@pytest.mark.parametrize("shape", [(64,), (33, 17), (4, 8, 16)])
def test_compressed_psum_matches_reference_over_20_rounds(shape):
    """20 rounds of error feedback, each side carrying its own residuals:
    every round's payloads, scales, totals and residuals; and the EF
    identity, sum of totals = sum of the parts + the first residuals - the
    last ones."""
    rng = np.random.default_rng(len(shape))
    n = 4
    e_ref = np.zeros((n,) + shape, np.float32)
    e_port = [torch.zeros(shape) for _ in range(n)]
    sum_tot, sum_x = np.zeros(shape, np.float64), np.zeros(shape, np.float64)
    for r in range(20):
        xs = (rng.normal(size=(n,) + shape) * (1 + r)).astype(np.float32)
        tot_ref, ne_ref = _ref_psum(xs, e_ref)
        for i in range(n):
            y = xs[i] + e_ref[i]
            q_ref, s_ref = j_comp.quantize_int8(jnp.asarray(y))
            q, s, _ = t_comp.quantize_part(torch.from_numpy(xs[i]), torch.from_numpy(e_ref[i]))
            assert q.dtype == torch.int8 and s.shape == ()
            assert float(s) == float(s_ref)
            _payloads_agree(q.numpy(), q_ref, y, s_ref)
        tot, e_port = t_comp.compressed_psum([torch.from_numpy(x) for x in xs], e_port, CPU)
        for i in range(n):
            _close(tot_ref[i], tot_ref[0], rtol=0)   # every shard holds one total
        _close(tot.numpy(), tot_ref[0])
        _close(np.stack([e.numpy() for e in e_port]), ne_ref, rtol=1e-5)
        sum_tot += tot.numpy()
        sum_x += xs.sum(0)
        e_ref = np.array(ne_ref)
    ef = sum_x - np.stack([e.numpy() for e in e_port]).astype(np.float64).sum(0)
    _close(sum_tot, ef)


def test_compressed_grad_allreduce_matches_reference_over_a_tree():
    rng = np.random.default_rng(7)
    n = 4
    shapes = {"item_emb": (50, 8), "tower": {"w": (8, 8), "b": (8,)}, "w0": ()}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        return rng.normal(size=(n,) + sh).astype(np.float32)

    g = draw(shapes)
    ef0 = t_comp.init_ef(jax.tree.map(lambda a: torch.from_numpy(np.array(a[0])), g))
    assert all(float(t.abs().sum()) == 0 for t in jax.tree.leaves(ef0.error))
    j_tot, j_ef = jax.vmap(
        lambda gg, ee: j_comp.compressed_grad_allreduce(gg, j_comp.EFState(ee), "data"),
        axis_name="data")(jax.tree.map(jnp.asarray, g),
                          jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), g))
    parts = [jax.tree.map(lambda a, i=i: torch.from_numpy(np.array(a[i])), g) for i in range(n)]
    t_tot, t_efs = t_comp.compressed_grad_allreduce(
        parts, [t_comp.init_ef(p) for p in parts], CPU)
    assert jax.tree.structure(t_tot) == jax.tree.structure(g)
    for got, want in zip(jax.tree.leaves(t_tot), jax.tree.leaves(j_tot)):
        _close(got.numpy(), np.asarray(want)[0])
    for i in range(n):
        for got, want in zip(jax.tree.leaves(t_efs[i].error), jax.tree.leaves(j_ef.error)):
            assert got.dtype == torch.float32
            _close(got.numpy(), np.asarray(want)[i])


def test_int8_sum_error_falls_with_error_feedback():
    """The same gradient each round: the running mean of the int8 totals
    approaches the exact sum as residuals feed back."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)) for _ in range(4)]
    exact = t_coll.fold_sum(xs, CPU)
    es, acc = [torch.zeros(256) for _ in xs], torch.zeros(256)
    errs = []
    for r in range(8):
        tot, es = t_comp.compressed_psum(xs, es, CPU)
        acc += tot
        errs.append(float(torch.max(torch.abs(acc / (r + 1) - exact))))
    assert errs[-1] < errs[0] / 4


@pytest.mark.parametrize("pods,data", [(2, 4), (1, 4), (2, 2)])
def test_hierarchical_psum_matches_reference(pods, data):
    rng = np.random.default_rng(pods * 10 + data)
    xs = rng.normal(size=(pods, data, 8, 5)).astype(np.float32)
    ref = jax.vmap(jax.vmap(lambda x: j_coll.hierarchical_psum(x, "pod", "data"),
                            axis_name="data"), axis_name="pod")(jnp.asarray(xs))
    grid = [[torch.from_numpy(xs[p, d]) for d in range(data)] for p in range(pods)]
    got = t_coll.hierarchical_psum(grid, CPU)
    for p in range(pods):
        for d in range(data):
            _close(got.numpy(), np.asarray(ref[p, d]))
    flat = t_coll.fold_sum([x for pod in grid for x in pod], CPU)
    _close(got.numpy(), flat.numpy())


def test_hierarchical_psum_without_a_pod_axis_is_fold_sum():
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(4, 6, 3)).astype(np.float32)
    ref = jax.vmap(lambda x: j_coll.hierarchical_psum(x, None, "data"),
                   axis_name="data")(jnp.asarray(xs))
    parts = [torch.from_numpy(x) for x in xs]
    got = t_coll.hierarchical_psum(parts, CPU, pod_axis=None)
    assert torch.equal(got, t_coll.fold_sum(parts, CPU))
    _close(got.numpy(), np.asarray(ref[0]))


def test_hierarchical_psum_refuses_a_dim_that_does_not_scatter():
    grid = [[torch.zeros(6, 2) for _ in range(4)] for _ in range(2)]
    with pytest.raises(ValueError, match="does not scatter"):
        t_coll.hierarchical_psum(grid, CPU)


@pytest.mark.parametrize("shape,axes,data_axes", [
    ((2, 2), ("data", "model"), ("data",)),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
    ((4,), ("data",), ("data",))])
def test_shard_batch_splits_rows_over_data_and_replicates_the_rest(shape, axes, data_axes):
    mesh = make_debug_mesh(shape, axes, devices="cpu")
    rng = np.random.default_rng(0)
    batch = {"hist": torch.from_numpy(rng.integers(0, 9, (8, 5)).astype(np.int32)),
             "labels": torch.from_numpy(rng.normal(size=8).astype(np.float32)),
             "step": torch.tensor(3),
             "mask": rng.integers(0, 2, 8).astype(bool)}
    out = shard_batch(batch, mesh, data_axes)
    sizes = dict(zip(axes, shape))
    n = int(np.prod([sizes[a] for a in data_axes]))
    for k, v in batch.items():
        v = torch.as_tensor(v)
        s = out[k]
        assert s.shape == tuple(v.shape)
        assert s.spec == (P(data_axes) if v.dim() else P())
        for ix in np.ndindex(*shape):
            coord = dict(zip(axes, ix))
            j = 0
            for a in data_axes:
                j = j * sizes[a] + coord[a]
            if v.dim():
                rows = v.shape[0] // n
                want = v[j * rows:(j + 1) * rows]
            else:
                want = v
            assert torch.equal(s.pieces[ix], want), (k, ix)


def test_shard_batch_refuses_a_leading_dim_that_does_not_divide():
    mesh = make_debug_mesh((4, 1), devices="cpu")
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": torch.zeros(6, 2)}, mesh)
