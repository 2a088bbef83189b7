"""The port's logical axes and sharding specs against the JAX reference,
and the placement of a tree on a mesh.

For every registered arch at its full config: ``param_axes()`` leaf for
leaf; ``train_state_pspecs`` (Adafactor's factored pairs included) on
2 x 2, 16 x 16 and 2 x 16 x 16; ``batch_pspecs`` on every shape that is
not skipped (the LM decode caches, MeshGraphNet's graph dims over every
axis). The reference's spec functions read only a mesh's axis names and
device-grid shape, so they run here on a stand-in mesh with no devices;
the port's run on its own ``Mesh`` of CPU devices, on ``meta`` params.
Specs compare as tuples with trailing ``None``s trimmed (the reference's
``P() != P(None)``); the comparison is exact. Then ``shard``/``unshard``
round-trip bit for bit, with each piece the shape its spec implies.
"""
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as j_sharding
from repro.models.api import get_arch as j_get_arch
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import get_arch, list_archs
from repro_torch.train import optimizer as t_opt

ARCHS = list_archs()
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(key):
    shape, axes = MESHES[key]
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))
    return ref, make_debug_mesh(shape, axes, devices="cpu")


def _trim(spec) -> tuple:
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _ref_tree(t):
    """A reference spec tree as nested dicts / tuples of trimmed tuples."""
    if isinstance(t, jax.sharding.PartitionSpec):
        return ("P",) + _trim(t)
    if t is None:
        return None
    if hasattr(t, "_fields"):
        return {f: _ref_tree(v) for f, v in zip(t._fields, t)}
    if isinstance(t, dict):
        return {k: _ref_tree(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_ref_tree(v) for v in t)
    raise TypeError(type(t))


def _port_tree(t):
    if isinstance(t, P):
        return ("P",) + tuple(t)
    if t is None:
        return None
    if hasattr(t, "_fields"):
        return {f: _port_tree(v) for f, v in zip(t._fields, t)}
    if isinstance(t, dict):
        return {k: _port_tree(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_port_tree(v) for v in t)
    raise TypeError(type(t))


def test_partition_spec_trims_compares_and_refuses_bad_entries():
    assert P(None) == P() and P("model", None) == P("model")
    assert tuple(P(None, ("pod", "data"), "model")) == (None, ("pod", "data"), "model")
    assert P("data") == P(("data",)) and P(()) == P() and len({P("a"), P("a", None)}) == 1
    assert P("data") != P("model") and P(("pod", "data")) != P(("data", "pod"))
    assert P(None, "model").mesh_axes(0) == () and P(("pod", "data")).mesh_axes(0) == ("pod", "data")
    assert P("model").mesh_axes(3) == ()
    with pytest.raises(TypeError):
        P(3)
    with pytest.raises(AttributeError):
        P("data")._parts = ()


@pytest.mark.parametrize("name", ARCHS)
def test_param_axes_match_reference(name):
    got = get_arch(name).param_axes()
    want = j_get_arch(name).param_axes()
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_train_state_pspecs_match_reference(name, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    got = _port_tree(S.train_state_pspecs(get_arch(name), port_mesh))
    want = _ref_tree(j_sharding.train_state_pspecs(j_get_arch(name), ref_mesh))
    assert got == want
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_batch_pspecs_match_reference(name, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ja, ta = j_get_arch(name), get_arch(name)
    shapes = [s for s, d in ta.shapes.items() if d.skip is None]
    assert shapes == [s for s, d in ja.shapes.items() if d.skip is None]
    for shape in shapes:
        t_step, j_step = ta.step(shape), ja.step(shape)
        assert t_step.batch_axes == j_step.batch_axes, shape
        got = _port_tree(S.batch_pspecs(ta, t_step, port_mesh))
        want = _ref_tree(j_sharding.batch_pspecs(ja, j_step, ref_mesh))
        assert got == want, shape


def test_graph_and_cache_dims_take_the_expected_axes():
    """MeshGraphNet's padded node/edge dims over every axis; an LM decode
    cache's batch over the data axes and its sequence over ``model``."""
    _, mesh = _meshes("2x16x16")
    gnn = get_arch("meshgraphnet")
    specs = S.batch_pspecs(gnn, gnn.step("minibatch_lg"), mesh)
    assert specs["edge_src"] == P(("pod", "data", "model"))
    lm = get_arch("deepseek-v3-671b")
    cache = S.batch_pspecs(lm, lm.step("decode_32k"), mesh)["cache"]
    assert cache["ckv"] == P(None, ("pod", "data"), "model")


def test_deepseek_v3_specs_take_seconds_and_no_memory():
    """deepseek-v3-671b at full depth: every abstract leaf on ``meta``,
    the specs in seconds, and FSDP + EP cut its bf16 params and factored
    Adafactor state to a few GB a position on 2 x 16 x 16."""
    _, mesh = _meshes("2x16x16")
    arch = get_arch("deepseek-v3-671b")
    t0 = time.perf_counter()
    state = arch.abstract_train_state("meta")
    specs = S.train_state_pspecs(arch, mesh)
    assert time.perf_counter() - t0 < 20.0
    leaves = []
    S.tree_map(leaves.append, state)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    params = sum(t.numel() for t in t_opt.leaves(state.params))
    assert 6.7e11 < params < 6.9e11
    per_dev = S.per_device_bytes(state, specs, mesh)
    whole = sum(t.numel() * t.element_size() for t in leaves)
    assert per_dev < whole / 100
    assert specs.params["moe_layers"]["moe"]["w_gate"] == P(None, "model", "data")
    assert specs.opt.mu is None
    row, col = specs.opt.nu["moe_layers"]["moe"]["w_gate"]
    assert (row, col) == (P(None, "model", "data"), P(None, "model"))


def test_qwen2_heads_replicate_on_a_model_axis_of_16():
    arch = get_arch("qwen2-1.5b")
    wq = S.param_pspecs(arch, _meshes("16x16")[1])["dense_layers"]["attn"]["wq"]
    assert wq == P()
    assert S.param_pspecs(arch, _meshes("2x2")[1])["dense_layers"]["attn"]["wq"] == \
        P(None, None, "model")
    x = torch.arange(2 * 8 * 12 * 4, dtype=torch.float32).reshape(2, 8, 12, 4)
    mesh = make_debug_mesh((1, 16), devices="cpu")
    placed = S.put(x, S.NamedSharding(mesh, wq))
    assert all(torch.equal(p, x) for p in placed.pieces.ravel())


@pytest.mark.parametrize("mesh_shape,axes", [((2, 2), ("data", "model")),
                                             ((2, 2, 2), ("pod", "data", "model")),
                                             ((4,), ("model",))])
@pytest.mark.parametrize("name", ["mind", "fm", "bert4rec", "deepseek-v3-671b", "meshgraphnet"])
def test_shard_unshard_round_trip(name, mesh_shape, axes):
    """Each piece has the global shape divided by its spec's axis sizes,
    lies on its position's device, equals its block of the tensor and is a
    copy of it; unsharding gives the tree back bit for bit."""
    arch = get_arch(name, smoke=True)
    mesh = make_debug_mesh(mesh_shape, axes, devices="cpu")
    state = arch.init_train_state(0, "cpu")
    specs = S.train_state_pspecs(arch, mesh)
    placed = S.shard(state, specs, mesh)
    sizes = dict(zip(axes, mesh_shape))

    def check(x, s, spec):
        for ix in np.ndindex(*mesh_shape):
            piece, coord, block = s.pieces[ix], dict(zip(axes, ix)), []
            for d, n in enumerate(x.shape):
                names = spec.mesh_axes(d)
                k = 0
                for a in names:
                    k = k * sizes[a] + coord[a]
                step = n // int(np.prod([sizes[a] for a in names]))
                block.append(slice(k * step, (k + 1) * step))
            assert piece.device == mesh.device(*ix) and piece.dtype == x.dtype
            assert tuple(piece.shape) == tuple(x[tuple(block)].shape)
            assert torch.equal(piece, x[tuple(block)])
            if piece.numel():
                assert piece.data_ptr() != x.data_ptr()
        return x

    S.tree_map(check, state, placed, specs)
    back = S.unshard(placed, "cpu")
    flat_a, flat_b = [], []
    S.tree_map(flat_a.append, state)
    S.tree_map(flat_b.append, back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_put_refuses_a_dim_that_does_not_split_or_an_unknown_axis():
    mesh = make_debug_mesh((2, 2), devices="cpu")
    with pytest.raises(ValueError, match="does not split"):
        S.put(torch.zeros(3, 4), S.NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="mesh axes"):
        S.put(torch.zeros(4), S.NamedSharding(mesh, P("pod")))
    with pytest.raises(ValueError, match="mesh axes"):
        S.put(torch.zeros(4, 4), S.NamedSharding(mesh, P("data", "data")))
    with pytest.raises(ValueError, match="more entries"):
        S.put(torch.zeros(4), S.NamedSharding(mesh, P(None, "data")))


def test_a_tuple_entry_splits_row_major_over_its_axes():
    mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    x = torch.arange(8 * 3).reshape(8, 3)
    s = S.put(x, S.NamedSharding(mesh, P(("pod", "data"))))
    for p, d, m in np.ndindex(2, 2, 2):
        k = p * 2 + d
        assert torch.equal(s.pieces[p, d, m], x[2 * k:2 * k + 2])
    assert torch.equal(S.gather(s, "cpu"), x)
