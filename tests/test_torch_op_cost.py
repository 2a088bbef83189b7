"""The port's op counter (``repro_torch/analysis/hlo_cost.py``) and
``obs.kern.modeled_cost`` against the reference's HLO cost model on the
CPU: a single product's flops and bytes, a loop's flops (the reference
multiplies a scan's body by its trip count, the port runs every
iteration), the smoke train steps of a dense LM, MIND and MeshGraphNet
against ``hlo_cost`` of the reference's jitted step, counts on ``meta``
equal to counts on ``cpu``, the live-bytes peak, and collective bytes by
type."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_cost as j_cost
from repro.models.api import get_arch as j_get_arch
from repro.obs import kern as j_kern
from repro_torch.analysis import hlo_cost
from repro_torch.distributed import collectives
from repro_torch.launch.dryrun import meta_batch
from repro_torch.models.api import get_arch
from repro_torch.models.testing import dummy_batch
from repro_torch.obs import kern

X = np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32)
W = np.random.default_rng(1).standard_normal((128, 256)).astype(np.float32)
W2 = np.random.default_rng(2).standard_normal((128, 128)).astype(np.float32) / 16


def _ref(fn, *args):
    return j_cost.analyze(jax.jit(fn).lower(*map(jnp.asarray, args)).compile().as_text())


def _loop(a, b):
    for _ in range(8):
        a = a @ b
    return a


def _scan(a, b):
    return jax.lax.scan(lambda c, _: (c @ b, None), a, None, length=8)[0]


def test_single_product_equals_the_reference():
    got = hlo_cost.analyze(lambda a, b: a @ b, torch.from_numpy(X), torch.from_numpy(W))
    want = _ref(lambda a, b: a @ b, X, W)
    assert (got["flops"], got["bytes"]) == (4_194_304, 229_376) == \
        (want["flops"], want["bytes"])
    assert got["flops_by_dtype"] == {"float32": 4_194_304}
    assert got["peak_bytes"] == 64 * 256 * 4          # the product's result
    assert (got["collective_bytes"], got["collective_counts"]) == (0.0, {})


def test_elementwise_tail_is_counted_unfused():
    """XLA fuses ``tanh(x @ w) + 1`` into one pass over the product
    (360,448 bytes); the port counts each op's reads and writes."""
    fn = lambda a, b: torch.tanh(a @ b) + 1        # noqa: E731
    got = hlo_cost.analyze(fn, torch.from_numpy(X), torch.from_numpy(W))
    assert got["bytes"] == 229_376 + 2 * (2 * 64 * 256 * 4) == 491_520
    assert _ref(lambda a, b: jnp.tanh(a @ b) + 1, X, W)["bytes"] == 360_448
    rows = hlo_cost.bytes_breakdown(fn, torch.from_numpy(X), torch.from_numpy(W))
    assert rows == [("aten.mm f32[64,256]", 229_376.0), ("aten.tanh f32[64,256]", 131_072.0),
                    ("aten.add f32[64,256]", 131_072.0)]


def test_loop_counts_every_iteration_like_the_reference_scan():
    got = hlo_cost.analyze(_loop, torch.from_numpy(X), torch.from_numpy(W2))
    assert got["flops"] == 16_777_216 == _ref(_scan, X, W2)["flops"]
    # a product's result is freed once the next one is written: two live
    assert got["peak_bytes"] == 2 * 64 * 128 * 4


def test_modeled_cost_agrees_with_the_reference():
    """The reference's ``modeled_cost`` compiles a zero-arg closure, whose
    arrays are constants XLA would fold at compile time: an optimization
    barrier keeps the product in its program."""
    x, w, w2 = torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(W2)
    jx, jw, jw2 = map(jnp.asarray, (X, W, W2))
    keep = jax.lax.optimization_barrier
    got = kern.modeled_cost(lambda: x @ w)
    assert got == j_kern.modeled_cost(lambda: keep(jx) @ keep(jw)) == {
        "modeled_hbm_bytes": 229_376.0, "modeled_flops": 4_194_304.0,
        "modeled_collective_bytes": 0.0}
    assert kern.modeled_cost(lambda: _loop(x, w2))["modeled_flops"] == \
        j_kern.modeled_cost(lambda: _scan(keep(jx), keep(jw2)))["modeled_flops"] == 16_777_216


def _port_step_cost(name, shape, counter=hlo_cost.OpCounter):
    arch = get_arch(name, smoke=True)
    spec = arch.step(shape)
    with counter() as c:
        spec.fn(arch.abstract_train_state("meta"), meta_batch(spec.input_specs))
    return c


def _ref_step_flops(name, shape):
    ja = j_get_arch(name, smoke=True)
    js = ja.step(shape)
    batch = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), js.input_specs)
    txt = jax.jit(js.fn).lower(ja.abstract_train_state(), batch).compile().as_text()
    return j_cost.analyze(txt)["flops"]


class _Gap(hlo_cost.OpCounter):
    """Also sums the kernel entries' modeled flops and those of batched
    products whose contracted size is 1: outer products, which XLA's
    simplifier rewrites as a broadcast multiply (no dot)."""

    outer = kernels = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.overloadpacket is torch.ops.aten.bmm and args[0].shape[-1] == 1:
            self.outer += self.flops - before
        return out

    def add_op(self, name, flops, nbytes, dtype, result):
        if name.startswith("kernel."):
            self.kernels += flops
        super().add_op(name, flops, nbytes, dtype, result)


@pytest.mark.parametrize("name,shape", [("qwen2-1.5b", "train_4k"), ("mind", "train_batch"),
                                        ("meshgraphnet", "molecule")])
def test_smoke_train_step_flops_match_the_reference(name, shape):
    """Within 1% of the reference's loop-aware count of its jitted step,
    once the named gap is taken out. The gap: kernel entries count their
    modeled fp32 operations (``kernels/cost.py``), where the reference's
    HLO has gathers and scatters (no dot); MIND's outer products of its
    routing backward (contracted size 1), which XLA turns into broadcast
    multiplies; and MIND's last routing iteration's logits update
    (``einsum("bsd,bid->bsi")``), which its step computes and never uses
    and XLA removes as dead code."""
    c = _port_step_cost(name, shape, _Gap)
    gap = c.kernels + c.outer
    if name == "mind":
        cfg = get_arch(name, smoke=True).cfg
        B = get_arch(name, smoke=True).step(shape).input_specs["hist"].shape[0]
        gap += 2.0 * B * cfg.hist_len * cfg.n_interests * cfg.embed_dim
    want = _ref_step_flops(name, shape)
    assert abs(c.flops - gap - want) <= 0.01 * want, (c.flops, gap, want)
    if name == "qwen2-1.5b":
        assert c.flops == want and gap == 0
    assert c.flops_by_dtype == {"float32": c.flops}


@pytest.mark.parametrize("name,shape", [("qwen2-1.5b", "train_4k"),
                                        ("meshgraphnet", "molecule"), ("fm", "train_batch")])
def test_counts_on_meta_equal_counts_on_cpu(name, shape):
    """The same step on real CPU tensors and on ``meta``: the same flops,
    bytes, dtypes and live-bytes peak (the kernel entries on these paths
    model no data-dependent work)."""
    arch = get_arch(name, smoke=True)
    spec = arch.step(shape)
    cpu = hlo_cost.analyze(spec.fn, arch.init_train_state(0, "cpu"),
                           dummy_batch(spec.input_specs, device="cpu"))
    meta = hlo_cost.analyze(spec.fn, arch.abstract_train_state("meta"),
                            meta_batch(spec.input_specs))
    assert cpu["flops"] > 0 or name == "fm"
    assert cpu == meta


def test_collective_bytes_by_type():
    parts = [torch.ones((4, 8)) * i for i in range(4)]
    with hlo_cost.OpCounter() as c:
        total = collectives.fold_sum(parts, "cpu")
        cat = collectives.all_gather(parts, "cpu", dim=1)
        h = collectives.hierarchical_psum([parts[:2], parts[2:]], "cpu")
    assert torch.equal(h, total) and cat.shape == (4, 32)
    # the hierarchical sum is one all-reduce: its inner folds and gather
    # belong to it
    assert c.collective_counts == {"all-reduce": 2, "all-gather": 1}
    assert c.collective_bytes == 2 * (4 * 8 * 4) + 4 * 32 * 4
    assert hlo_cost.analyze(collectives.fold_sum, parts, "cpu")["collective_counts"] == \
        {"all-reduce": 1}
    # outside a counter nothing is recorded and nothing changes
    assert torch.equal(collectives.fold_sum(parts, "cpu"), total)
