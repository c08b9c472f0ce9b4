"""A1, the multi-tensor Keras Adam (``ops/keras_adam.py``), against the
eager update of one leaf at a time (``keras_adam_reference``, the CPU's
route).

On the CPU the kernel's C entry is replaced by a stand-in that reads the
launch table from host memory as the entry does and applies the kernel's
arithmetic to the tensors' memory in PyTorch's fp32 CPU ops, and every
leaf is routed to the kernel, so ``KerasAdam.step`` takes the card's route (table,
launches, stamp, version bumps) on CPU tensors. The ``card`` tests run the
kernel itself and skip without a CUDA device. The file imports nothing of
JAX, so it runs on the card as it is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_keras_adam.py
"""

import copy
import ctypes
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402

from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import cuda_lib, keras_adam  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import dec0 as D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import KerasAdam  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    load_optax_adam_state, to_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# odd sizes (ragged vector tails), tile edges (2048 elements a tile) and
# conv-like shapes
SHAPES = [(1,), (3,), (4,), (5,), (7, 3), (16,), (2047,), (2048,), (2049,),
          (4101,), (8, 4, 3, 3, 3), (16, 16, 3, 3, 3), (33, 5)]


def _floats(address: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(address))


class StandIn:
    """``cuda_lib.run`` for ``fetal_keras_adam`` on host memory: the C
    entry's table read as it reads it, the kernel's sequence of fp32
    operations on its fp32 scalars, in PyTorch's CPU ops (whose fp32 sqrt
    the composite on the CPU shares; it is not rounded as the card's is).
    Records each launch's leaf count."""

    def __init__(self):
        self.launches = []

    def __call__(self, entry, op, args, device):
        assert (entry, op) == ("fetal_keras_adam", keras_adam.PROFILER_NAME)
        leaves, rows, alpha, scalars = args
        assert 1 <= leaves <= keras_adam.MAX_LEAVES
        self.launches.append(leaves)
        table = np.ctypeslib.as_array(
            (ctypes.c_longlong * (5 * leaves)).from_address(rows))
        b1, omb1, b2, omb2, eps, neg_lr = map(float, _floats(scalars, 6))
        for (p, g, m, v, n), a in zip(table.reshape(leaves, 5),
                                      _floats(alpha, leaves)):
            p, g, m, v = (torch.from_numpy(_floats(int(t), int(n)))
                          for t in (p, g, m, v))
            m.mul_(b1).add_(g * omb1)
            v.mul_(b2).add_(g.mul(omb2).mul_(g))
            p.add_(m.mul(float(a)).div_(v.sqrt().add_(eps)).mul_(neg_lr))


@pytest.fixture
def stand_in(monkeypatch):
    launcher = StandIn()
    monkeypatch.setattr(cuda_lib, "run", launcher)
    monkeypatch.setattr(keras_adam, "takes", lambda p: True)
    monkeypatch.setattr(keras_adam.keras_adam, "launches", 0)
    monkeypatch.setattr(keras_adam.keras_adam, "leaves", 0)
    return launcher


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: A1 runs on the card only")
    return torch.device("cuda", 0)


def _composite_step(opt, monkeypatch):
    """``opt.step()`` on the eager update of one leaf at a time."""
    with monkeypatch.context() as m:
        m.setattr(keras_adam, "takes", lambda p: False)
        opt.step()


def _leaves(shapes, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return [nn.Parameter(torch.randn(s, generator=gen).to(device))
            for s in shapes]


def _grads(leaves, seed, scale=0.1, skip=()):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i, p in enumerate(leaves):
        g = torch.randn(p.shape, generator=gen) * scale
        out.append(None if i in skip else g.to(p.device))
    return out


def _set_grads(leaves, grads):
    for p, g in zip(leaves, grads):
        p.grad = None if g is None else g.clone()


def _assert_same(opt_a, opt_b, leaves_a, leaves_b):
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b)
        sa, sb = opt_a.state[a], opt_b.state[b]
        assert set(sa) == set(sb)
        if sa:
            assert sa["count"] == sb["count"]
            assert torch.equal(sa["mu"], sb["mu"])
            assert torch.equal(sa["nu"], sb["nu"])


def _run_both(steps, leaves_a, leaves_b, opt_a, opt_b, monkeypatch, seed=0,
              skip=(), lr_at=None):
    for t in range(steps):
        if lr_at is not None and t == lr_at[0]:
            opt_a.set_learning_rate(lr_at[1])
            opt_b.set_learning_rate(lr_at[1])
        grads = _grads(leaves_a, seed + t, skip=skip)
        _set_grads(leaves_a, grads)
        _set_grads(leaves_b, grads)
        opt_a.step()
        _composite_step(opt_b, monkeypatch)


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_kernel_route_equals_composite(stand_in, monkeypatch, clip_norm):
    """Five steps of 100 leaves, a learning-rate change after two: p, m and
    v bit for bit the eager update's, two launches a step."""
    shapes = (SHAPES * 8)[:100]
    a, b = _leaves(shapes, 1), _leaves(shapes, 1)
    opt_a = KerasAdam(a, lr=1e-2, clip_norm=clip_norm)
    opt_b = KerasAdam(b, lr=1e-2, clip_norm=clip_norm)
    _run_both(5, a, b, opt_a, opt_b, monkeypatch, lr_at=(2, 2.5e-3))
    _assert_same(opt_a, opt_b, a, b)
    assert stand_in.launches == [80, 20] * 5
    assert keras_adam.keras_adam.launches == 10
    assert keras_adam.keras_adam.leaves == 500
    assert not all(torch.equal(p, q) for p, q in zip(a, _leaves(shapes, 1)))


class _Named(nn.Module):
    """Leaves with the port's parameter names, for the optax import."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv3d(4, 8, 3)
        self.conv2 = nn.Conv3d(8, 3, 3)


def _load(opt, model, how, seed):
    """A load that replaces every moment: ``how`` is
    ``load_state_dict`` or ``load_optax_adam_state``."""
    gen = torch.Generator().manual_seed(seed)
    named = dict(model.named_parameters())
    mu = {k: torch.randn(p.shape, generator=gen) * 0.01
          for k, p in named.items()}
    nu = {k: torch.rand(p.shape, generator=gen) * 1e-4
          for k, p in named.items()}
    if how == "load_optax_adam_state":
        load_optax_adam_state(opt, model, 4, to_flax(mu), to_flax(nu), 3e-3)
        return
    params = list(model.parameters())
    name_of = {id(p): k for k, p in named.items()}
    state = opt.state_dict()
    state["state"] = {i: {"count": 4, "mu": mu[name_of[id(p)]].clone(),
                          "nu": nu[name_of[id(p)]].clone()}
                      for i, p in enumerate(params)}
    opt.load_state_dict(state)


@pytest.mark.parametrize("how", ["load_state_dict", "load_optax_adam_state"])
def test_table_built_once_and_rebuilt_after_a_load(stand_in, monkeypatch,
                                                   how):
    """The launch table is made at the first step and kept while the
    pointers stay; a load that replaces the moments makes a new one, and
    the steps after it still equal the eager update's."""
    torch.manual_seed(0)
    model_a = _Named()
    model_b = copy.deepcopy(model_a)
    a, b = list(model_a.parameters()), list(model_b.parameters())
    opt_a, opt_b = KerasAdam(a, lr=1e-2), KerasAdam(b, lr=1e-2)
    _run_both(1, a, b, opt_a, opt_b, monkeypatch)
    table = opt_a._tables[0]
    _run_both(2, a, b, opt_a, opt_b, monkeypatch, seed=1)
    assert opt_a._tables[0] is table
    _load(opt_a, model_a, how, 7)
    _load(opt_b, model_b, how, 7)
    _run_both(2, a, b, opt_a, opt_b, monkeypatch, seed=3)
    assert opt_a._tables[0] is not table
    assert opt_a.state[a[0]]["count"] == 6
    _assert_same(opt_a, opt_b, a, b)


def test_leaves_without_a_gradient_are_skipped(stand_in, monkeypatch):
    """A leaf with no gradient gets no state and no row; when the set of
    leaves with gradients changes, the table is made again."""
    a, b = _leaves(SHAPES[:6], 2), _leaves(SHAPES[:6], 2)
    opt_a, opt_b = KerasAdam(a, lr=1e-2), KerasAdam(b, lr=1e-2)
    _run_both(2, a, b, opt_a, opt_b, monkeypatch, skip=(1, 3, 5))
    assert [bool(opt_a.state[p]) for p in a] == [True, False] * 3
    assert keras_adam.keras_adam.leaves == 6
    assert torch.equal(a[1], _leaves(SHAPES[:6], 2)[1])
    table = opt_a._tables[0]
    _run_both(1, a, b, opt_a, opt_b, monkeypatch, seed=5)
    assert opt_a._tables[0] is not table
    assert [opt_a.state[p]["count"] for p in a] == [3, 1] * 3
    _assert_same(opt_a, opt_b, a, b)


def test_loaded_non_contiguous_moments_are_made_contiguous(stand_in,
                                                          monkeypatch):
    """Moments loaded as transposed views are made contiguous in the
    optimizer's state once, and the update still equals the eager one's
    (which steps the views in place)."""
    shapes = [(6, 5), (4, 3, 2), (7,)]
    a, b = _leaves(shapes, 3), _leaves(shapes, 3)
    opt_a, opt_b = KerasAdam(a, lr=1e-2), KerasAdam(b, lr=1e-2)
    gen = torch.Generator().manual_seed(4)
    state = {}
    for i, s in enumerate(shapes):
        mu, nu = (torch.rand(s[::-1], generator=gen).permute(
            *reversed(range(len(s)))) for _ in range(2))
        state[i] = {"count": 2, "mu": mu, "nu": nu * 1e-3}
    for opt in (opt_a, opt_b):
        sd = opt.state_dict()
        sd["state"] = copy.deepcopy(state)
        opt.load_state_dict(sd)
    assert not opt_a.state[a[0]]["mu"].is_contiguous()
    _run_both(1, a, b, opt_a, opt_b, monkeypatch)
    table = opt_a._tables[0]
    for p in a:
        assert opt_a.state[p]["mu"].is_contiguous()
        assert opt_a.state[p]["nu"].is_contiguous()
    _run_both(2, a, b, opt_a, opt_b, monkeypatch, seed=1)
    assert opt_a._tables[0] is table
    _assert_same(opt_a, opt_b, a, b)


@pytest.mark.parametrize("leaf", ["bfloat16", "float16", "float64",
                                  "non_contiguous", "grad_non_contiguous"])
def test_kernel_route_refuses_what_the_kernel_does_not_take(stand_in, leaf):
    """A leaf routed to the kernel that is not a contiguous fp32 tensor, or
    whose gradient is not contiguous, raises; nothing is launched."""
    dtype = getattr(torch, leaf, torch.float32)
    base = torch.randn(6, 4, dtype=dtype)
    p = nn.Parameter(base.t() if leaf == "non_contiguous" else base)
    p.grad = (torch.randn(4, 6).t() if leaf == "grad_non_contiguous"
              else torch.randn(p.shape, dtype=dtype))
    opt = KerasAdam([p], lr=1e-2)
    error = TypeError if leaf in ("bfloat16", "float16", "float64") else (
        ValueError)
    with pytest.raises(error, match="keras_adam"):
        opt.step()
    assert stand_in.launches == []


@pytest.mark.parametrize("n", [1, 80, 81, 114, 151, 161])
def test_table_is_split_into_launches(stand_in, n):
    """At most ``MAX_LEAVES`` leaves a launch, in order: Isensee2017's 114
    leaves take two launches, Swin UNETR's 151 two, the U-Net's 30 one."""
    leaves = _leaves([(3,)] * n, 5)
    opt = KerasAdam(leaves, lr=1e-2)
    _set_grads(leaves, _grads(leaves, 6))
    opt.step()
    want = math.ceil(n / keras_adam.MAX_LEAVES)
    assert len(stand_in.launches) == keras_adam.keras_adam.launches == want
    assert sum(stand_in.launches) == keras_adam.keras_adam.leaves == n
    assert all(k == keras_adam.MAX_LEAVES for k in stand_in.launches[:-1])
    table = opt._tables[0]
    starts = [rows for _, rows, _ in table.launches]
    assert starts == [ctypes.addressof(table.rows) + 40 * keras_adam.MAX_LEAVES
                      * i for i in range(want)]


def test_prepared_weights_follow_kernel_steps(stand_in):
    """A write through the table's pointers bumps the version of every
    stepped parameter and moment, so ``cuda_lib.cached`` makes the fused
    decoder's pre-summed weights again from the stepped parameter (the
    check of ``test_torch_kernel_grad.py::
    test_prepared_weights_follow_optimizer_steps`` on the kernel's
    route)."""
    torch.manual_seed(2)
    up, sk, co = 16, 8, 8
    block = ConvBlock(up + sk, co, dtype=torch.bfloat16, use_kernel_dec0=True,
                      use_kernel_conv=True)
    opt = KerasAdam(block.parameters(), lr=0.1)

    def prepared():
        k = block._kernel_dhwio()
        return k, cached(k, ("dec0", up), lambda t: D.kernel_weights(t, up))

    cached = cuda_lib.cached
    with torch.no_grad():
        k0, w0 = prepared()
        assert block._kernel_dhwio() is k0
    versions = [p._version for p in block.parameters()]
    xd, skip = torch.randn(1, 2, 2, 2, up), torch.randn(1, 4, 4, 4, sk)
    block((xd, skip)).float().sum().backward()
    opt.step()
    assert stand_in.launches == [len(versions)]
    assert all(p._version > v for p, v in zip(block.parameters(), versions))
    for s in opt.state.values():
        assert s["mu"]._version > 0 and s["nu"]._version > 0
    with torch.no_grad():
        k1, w1 = prepared()
        assert k1 is not k0
        fresh = block.conv.weight.to(torch.bfloat16).permute(2, 3, 4, 1, 0)
        torch.testing.assert_close(k1, fresh, atol=0, rtol=0)
        for x, y, old in zip(w1, D.kernel_weights(fresh, up), w0):
            torch.testing.assert_close(x, y, atol=0, rtol=0)
            assert not torch.equal(x, old)


def test_scalars_round_as_the_composite():
    """The kernel's scalars are the composite's Python numbers rounded to
    fp32 once: 1 - b1 from the double, -lr from the fp32 lr."""
    got = keras_adam.scalars(0.9, 0.999, 1e-7, 5e-4)
    want = [np.float32(0.9), np.float32(1 - 0.9), np.float32(0.999),
            np.float32(1 - 0.999), np.float32(1e-7), -np.float32(5e-4)]
    assert got == [float(w) for w in want]
    assert got[1] != float(np.float32(1) - np.float32(0.9))


# ---- on the card ----------------------------------------------------------


def _model_leaves(kind, device):
    if kind == "ragged":
        # odd sizes, and views 4 bytes off a 16-byte boundary (the
        # element-by-element path)
        gen = torch.Generator().manual_seed(8)
        out = []
        for i, s in enumerate((SHAPES * 8)[:100]):
            n = math.prod(s)
            buf = torch.randn(n + 1, generator=gen).to(device)
            out.append(nn.Parameter(buf[i % 2:i % 2 + n].view(s)))
        return None, out
    folder = (("fetal_mri_segmentation_tpu_torch", "configs")
              if kind == "swin_unetr" else ("configs",))
    cfg = Config.load(os.path.join(REPO, *folder, f"fetal_{kind}.json"))
    torch.manual_seed(0)
    model = build_model(cfg, device=device)
    return model, list(model.parameters())


@pytest.mark.card
@pytest.mark.parametrize("scenario", ["lr_change", "optax_load", "clip"])
@pytest.mark.parametrize("kind,leaves,launches", [
    ("isensee", 114, 2), ("unet", 30, 1), ("swin_unetr", 151, 2),
    ("ragged", 100, 2)])
def test_kernel_equals_composite_on_the_card(card, monkeypatch, kind, leaves,
                                             launches, scenario):
    """Five steps of A1 against the eager update on CUDA tensors: p, m and
    v equal bit for bit; one launch for up to 80 leaves, every leaf on A1."""
    model_a, a = _model_leaves(kind, card)
    model_b, b = _model_leaves(kind, card)
    assert len(a) == leaves
    with torch.no_grad():
        for p, q in zip(a, b):
            q.copy_(p)
    clip = 0.5 if scenario == "clip" else None
    opt_a, opt_b = KerasAdam(a, 5e-4, clip_norm=clip), KerasAdam(
        b, 5e-4, clip_norm=clip)
    if scenario == "optax_load":
        if kind in ("ragged", "swin_unetr"):
            pytest.skip(f"{kind}: no flax layout to import moments from")
        for opt, model in ((opt_a, model_a), (opt_b, model_b)):
            _load(opt, model, "load_optax_adam_state", 9)
    monkeypatch.setattr(keras_adam.keras_adam, "launches", 0)
    monkeypatch.setattr(keras_adam.keras_adam, "leaves", 0)
    _run_both(5, a, b, opt_a, opt_b, monkeypatch,
              lr_at=(2, 2.5e-4) if scenario == "lr_change" else None)
    torch.cuda.synchronize()
    _assert_same(opt_a, opt_b, a, b)
    assert keras_adam.keras_adam.launches == 5 * launches
    assert keras_adam.keras_adam.leaves == 5 * leaves


@pytest.mark.card
def test_kernel_launches_sit_in_their_host_op(card):
    """While a profiler runs, each launch sits in the host op
    ``fetal::keras_adam``, which the profiler links to its kernel."""
    _, leaves = _model_leaves("isensee", card)
    opt = KerasAdam(leaves, 5e-4)
    for t in range(2):
        _set_grads(leaves, _grads(leaves, t))
        opt.step()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.step()
        torch.cuda.synchronize()
    ops = {e.key: e for e in prof.key_averages()}
    assert ops[keras_adam.PROFILER_NAME].count == 2
    kernels = [k for k in ops if "keras_adam_kernel" in k]
    assert kernels and ops[kernels[0]].count == 2
