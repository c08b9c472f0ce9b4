"""The fused InstanceNorm + activation (``ops/instance_norm.py``) on the CPU:
its plain twin over the (B, N, C) view against the layers' composite
(``InstanceNorm`` then ``apply_activation``), unfolded and folded; the
training Function over the twins of its forward and backward against
autograd through the composite; the backward kernel's algebra and
partials layout; the conv block's activation inside the norm module's
forward; the launch plan and its chunked moments; and the route
``InstanceNorm._takes_kernel`` chooses, counted with the launchers replaced
by counting ones on CPU tensors, with the kernel's checks that refuse what
it does not take (the kernels themselves run only on the card:
``chip_smoke.py``'s norm phase).

Tolerances: fp32 atol 1e-5, rtol 1e-5 (the same fp32 formula, sums taken
over another view); bf16 one bf16 step (rtol 2^-7: an fp32 value that the
two sums put on either side of a rounding boundary). Gradients, as a share
of the largest reference element (``GRAD_TOL``): fp32 2e-6 (the same
derivative in another fp32 formula: 1.8e-7 at most measured); bf16 2^-7
(autograd rounds the LeakyReLU's product dy * slope to bf16, 2^-9 of it,
where the Function keeps dz in fp32: 2.8e-3 at most measured).
"""

import math

import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu_torch.models import layers  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.isensee2017 import (  # noqa: E402
    Isensee2017)
from fetal_mri_segmentation_tpu_torch.models.layers import (  # noqa: E402
    ConvBlock, FoldedInstanceNorm, InstanceNorm)
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import fold as fold_ops  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import (  # noqa: E402
    apply_activation)
from fetal_mri_segmentation_tpu_torch.ops import (  # noqa: E402
    instance_norm as norm_ops)
from fetal_mri_segmentation_tpu_torch.ops.instance_norm import (  # noqa: E402
    THREADS, UNROLL, _available, _geometry, instance_norm_act,
    instance_norm_act_backward, instance_norm_act_backward_reference,
    instance_norm_act_reference, instance_norm_act_train,
    instance_norm_moments_reference, norm_plan)

torch.set_num_threads(1)
SLOPE = 0.3
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}
GRAD_TOL = {torch.float32: 2e-6, torch.bfloat16: 2 ** -7}


def _norm(c, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    norm = InstanceNorm(c, dtype=dtype)
    with torch.no_grad():
        norm.scale.copy_(1 + 0.5 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.5 * torch.randn(c, generator=gen))
    return norm


def _input(shape, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    # a mean far from zero, as after a conv with a bias
    return (3.0 + 2.0 * torch.randn(*shape, generator=gen)).to(dtype)


@pytest.mark.parametrize("activation", ["leaky_relu", "relu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("factors", [None, (1, 1, 2)],
                         ids=["unfolded", "fold112"])
def test_twin_matches_composite(factors, dtype, activation):
    c = 16
    norm = _norm(c, dtype)
    x = _input((2, 4, 6, 8, c), dtype)
    fold = 1
    if factors:
        x = fold_ops.fold(x, factors)
        fold = math.prod(factors)
    want = apply_activation(norm(x, fold=fold), activation, SLOPE)
    got = instance_norm_act_reference(
        x.reshape(x.shape[0], -1, c), norm.scale, norm.bias, activation,
        SLOPE, norm.epsilon).reshape(x.shape)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got, want, **TOL[dtype])
    # the CPU entry point is the twin on the same view
    torch.testing.assert_close(
        instance_norm_act(x, norm.scale, norm.bias, activation, SLOPE,
                          norm.epsilon), got, atol=0, rtol=0)


def _close_to(got, want, tol):
    """max|got - want| within ``tol`` of max|want|."""
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def _grads(fn, x, params, dy):
    y = fn()
    return (y, *torch.autograd.grad(y, [x, *params], dy))


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("activation", ["leaky_relu", "relu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("factors", [None, (1, 1, 2)],
                         ids=["unfolded", "fold112"])
def test_function_matches_composite_autograd(factors, dtype, activation,
                                             affine):
    """The training Function (the twins on the CPU) against autograd
    through the composite: y, dx and, with affine, dscale and dbias in
    fp32; without affine no gradient reaches the buffers."""
    c = 16
    norm = _norm(c, dtype) if affine else InstanceNorm(c, dtype=dtype,
                                                       affine=False)
    x = _input((2, 4, 6, 8, c), dtype)
    fold = 1
    if factors:
        x = fold_ops.fold(x, factors)
        fold = math.prod(factors)
    x.requires_grad_(True)
    gen = torch.Generator().manual_seed(5)
    dy = torch.randn(x.shape, generator=gen).to(dtype)
    params = [norm.scale, norm.bias] if affine else []
    got = _grads(lambda: instance_norm_act_train(
        x, norm.scale, norm.bias, activation, SLOPE, norm.epsilon), x,
        params, dy)
    want = _grads(lambda: norm._composite(x, False, fold, activation, SLOPE),
                  x, params, dy)
    torch.testing.assert_close(got[0], want[0], **TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        _close_to(g, w, GRAD_TOL[dtype])
    assert got[1].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got[2:])
    assert not norm.scale.requires_grad or affine


@pytest.mark.parametrize("activation", ["leaky_relu", "relu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_twin_matches_autograd_of_twin(dtype, activation):
    """The backward twin from the moments twin equals autograd through the
    forward twin over the (B, N, C) view, in fp32 throughout."""
    c = 16
    norm = _norm(c, torch.float32)
    x = _input((3, 40, c), dtype)
    gen = torch.Generator().manual_seed(6)
    dy = torch.randn(x.shape, generator=gen).to(dtype)
    moments = instance_norm_moments_reference(x, norm.epsilon)
    xf = x.float()
    torch.testing.assert_close(moments[0], xf.mean(1))
    torch.testing.assert_close(
        moments[1], torch.rsqrt(xf.var(1, correction=0) + norm.epsilon))
    dx, dparams = instance_norm_act_backward_reference(
        dy, x, moments, norm.scale, norm.bias, activation, SLOPE)
    assert dx.dtype == dtype and dparams.shape == (2, c)
    xg = xf.clone().requires_grad_(True)
    want = torch.autograd.grad(
        instance_norm_act_reference(xg, norm.scale, norm.bias, activation,
                                    SLOPE, norm.epsilon),
        [xg, norm.scale, norm.bias], dy.float())
    _close_to(dx.float(), want[0], GRAD_TOL[dtype])
    _close_to(dparams[0], want[1], 1e-5)
    _close_to(dparams[1], want[2], 1e-5)


def _kernel_backward(dy, x, moments, scale, bias, activation, plan):
    """The three backward launches as ``csrc/instance_norm.cu`` orders
    them, over (B, rows, C): partial (S1, S2) per chunk of rows, each
    sample's sums over every G-th chunk then over G, dx = a dz + k1 + k2
    x^, and the parameters over the B x chunks partials of a channel."""
    b, rows, c = x.shape
    xf, mean, rstd = x.float(), moments[0][:, None], moments[1][:, None]
    a = rstd * scale
    z = ((xf - mean) * a + bias).to(x.dtype)
    dz = dy.float()
    if activation != "none":
        dz = torch.where(z > 0, dz,
                         dz * (SLOPE if activation == "leaky_relu" else 0))
    xhat = (xf - mean) * rstd
    part = torch.stack([torch.stack(
        [dz[:, k * plan.chunk_rows:(k + 1) * plan.chunk_rows].sum(1),
         (dz * xhat)[:, k * plan.chunk_rows:(k + 1) * plan.chunk_rows].sum(
             1)], -1) for k in range(plan.chunks)], 1)  # (B, chunks, C, 2)
    groups = THREADS // c if c < THREADS else 1
    sums = sum(part[:, g::groups].sum(1) for g in range(groups))
    dx = (a * dz - a * sums[:, None, :, 0] / rows
          - a * sums[:, None, :, 1] / rows * xhat)
    flat = part.reshape(b * plan.chunks, c, 2)
    params = sum(flat[g::groups].sum(0) for g in range(groups))
    return dx.to(x.dtype), torch.stack([params[:, 1], params[:, 0]])


@pytest.mark.parametrize("batch,rows,channels", [
    (6, 16 ** 3, 16), (6, 8 ** 3, 32), (3, 4 ** 3, 256), (2, 1000, 24)])
@pytest.mark.parametrize("activation", ["leaky_relu", "none"])
def test_kernel_backward_algebra_matches_twin(batch, rows, channels,
                                              activation):
    """What the backward launches compute, at the forward's plan, equals
    the twin: every row in one chunk, the dx terms, dscale from S2 and
    dbias from S1."""
    norm = _norm(channels, torch.float32)
    x = _input((batch, rows, channels), torch.float32, seed=7)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    moments = instance_norm_moments_reference(x, norm.epsilon)
    plan = norm_plan(batch, rows, channels, 4, 132)
    with torch.no_grad():
        got = _kernel_backward(dy, x, moments, norm.scale, norm.bias,
                               activation, plan)
        want = instance_norm_act_backward_reference(
            dy, x, moments, norm.scale, norm.bias, activation, SLOPE)
    for g, w in zip(got, want):
        _close_to(g, w, GRAD_TOL[torch.float32])


def test_backward_asks_no_parameter_gradient_without_affine(monkeypatch):
    """Where scale and bias want no gradient (buffers), the backward is
    asked for none: on the card its third launch is left out."""
    asked = []

    def counting(*args, params):
        asked.append(params)
        return instance_norm_act_backward(*args, params=params)

    monkeypatch.setattr(norm_ops, "instance_norm_act_backward", counting)
    for affine in (False, True):
        norm = (_norm(16, torch.float32) if affine
                else InstanceNorm(16, dtype=torch.float32, affine=False))
        x = _input((2, 4, 4, 4, 16), torch.float32).requires_grad_(True)
        instance_norm_act_train(x, norm.scale, norm.bias, "leaky_relu",
                                SLOPE, norm.epsilon).sum().backward()
        assert x.grad is not None
        assert (norm.scale.grad is not None) is affine
    assert asked == [False, True]
    dx, dparams = instance_norm_act_backward(
        torch.ones(1, 4, 8), _input((1, 4, 8), torch.float32),
        instance_norm_moments_reference(_input((1, 4, 8), torch.float32)),
        torch.ones(8), torch.zeros(8), params=False)
    assert dparams is None and dx.shape == (1, 4, 8)


@pytest.mark.parametrize("x,scale", [
    (torch.zeros(2, 4, 16, device="meta"), torch.ones(16)),
    (torch.zeros(2, 4, 16, device="meta"), torch.ones(16, device="meta"))],
    ids=["meta_x", "meta_all"])
def test_backward_entry_refuses_what_is_not_a_cuda_tensor(x, scale):
    moments = torch.zeros(2, 2, 16, device=x.device)
    with pytest.raises(ValueError, match="instance_norm_act"):
        instance_norm_act_backward(torch.zeros_like(x), x, moments, scale,
                                   torch.zeros_like(scale), "leaky_relu")


@pytest.mark.parametrize("activation", ["leaky_relu", "relu"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_conv_block_activation_inside_norm(activation, grad):
    """The block's output as before (conv, norm, then the activation), and
    the activation now inside the ``in`` module's forward: its hook sees
    the block's output."""
    torch.manual_seed(0)
    block = ConvBlock(8, 16, instance_normalization=True,
                      activation=activation, negative_slope=SLOPE,
                      dtype=torch.float32)
    norm = block._modules["in"]
    assert type(norm).__name__ == "InstanceNorm"
    seen = []
    handle = norm.register_forward_hook(lambda m, a, out: seen.append(out))
    x = _input((2, 6, 6, 6, 8), torch.float32)
    with torch.set_grad_enabled(grad):
        out = block(x)
        handle.remove()
        want = apply_activation(norm(block._plain_conv(x)), activation,
                                SLOPE)
    assert len(seen) == 1 and seen[0] is out
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    assert (out < 0).any() == (activation == "leaky_relu")


def test_folded_block_activation_inside_norm():
    torch.manual_seed(0)
    block = ConvBlock(8, 16, instance_normalization=True,
                      activation="leaky_relu", negative_slope=SLOPE,
                      dtype=torch.float32)
    x = _input((1, 6, 6, 6, 8), torch.float32)
    seen = []
    block._modules["in"].register_forward_hook(
        lambda m, a, out: seen.append(out))
    with torch.no_grad():
        out = block(fold_ops.fold(x, (1, 1, 2)), fold=(1, 1, 2))
        plain = block(x)
    assert len(seen) == 2 and seen[0] is out
    torch.testing.assert_close(fold_ops.unfold(out, (1, 1, 2)), plain,
                               atol=1e-4, rtol=1e-4)


def test_folded_instance_norm_takes_the_route(route):
    """``FoldedInstanceNorm`` reaches the launcher with the folded tensor,
    which the twin reads as (B, N*F, C), and gives its composite's
    output."""
    norm = FoldedInstanceNorm(16, 2, dtype=torch.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.linspace(0.5, 1.5, 16))
        norm.bias.copy_(torch.linspace(-1, 1, 16))
    x = fold_ops.fold(_input((2, 4, 4, 6, 16), torch.float32), (1, 1, 2))
    with torch.no_grad():
        got = norm(x)
        want = norm._composite(x, False, 2, "none", 0.0)
    assert route.calls == 1
    torch.testing.assert_close(got, want, **TOL[torch.float32])


# Isensee2017's norm shapes on the serving path: levels 0-4 of a batch of
# 64^3 patches (16 base filters), at the batch of 8 and the last batch of 3
NORM_SHAPES = [(b, (64 >> level) ** 3, 16 << level)
               for b in (8, 3) for level in range(5)]


@pytest.mark.parametrize("batch,rows,channels", NORM_SHAPES + [
    (8, 64 ** 3, 32), (8, 64 ** 3, 64),
    (1, 1, 8), (2, 5, 1024)])
@pytest.mark.parametrize("vec", [8, 4], ids=["bf16", "fp32"])
def test_norm_plan_covers_every_row(batch, rows, channels, vec):
    plan = norm_plan(batch, rows, channels, vec, 132)
    per_pass = THREADS // (channels // vec)
    assert plan.chunks * plan.chunk_rows >= rows
    assert (plan.chunks - 1) * plan.chunk_rows < rows
    assert plan.chunk_rows >= UNROLL * per_pass
    assert plan.blocks >= 1
    if rows >= 32768:
        # every SM has work in both launches
        assert batch * plan.chunks >= 132 and batch * plan.blocks >= 132


@pytest.mark.parametrize("rows,chunk_rows", [(4096, 512), (1000, 96),
                                             (7, 8)])
def test_chunked_moments_match_two_pass(rows, chunk_rows):
    """The kernel's merge: per-chunk (mean, M2) from chunk counts, merged
    pairwise (Chan), equals the two-pass moments."""
    x = _input((rows, 8), torch.float64, seed=3)
    n = torch.zeros(8, dtype=torch.float64)
    mean, m2 = torch.zeros_like(n), torch.zeros_like(n)
    for k in range(-(-rows // chunk_rows)):
        part = x[k * chunk_rows:(k + 1) * chunk_rows]
        nb = part.shape[0]
        mb = part.mean(0)
        m2b = ((part - mb) ** 2).sum(0)
        total = n + nb
        delta = mb - mean
        mean = mean + delta * nb / total
        m2 = m2 + m2b + delta * delta * n * nb / total
        n = total
    torch.testing.assert_close(mean, x.mean(0))
    torch.testing.assert_close(m2 / rows, x.var(0, correction=0))


class _Counting:
    """Stands in for a launcher on CPU tensors: counts calls, runs the
    plain twins."""

    def __init__(self, fn=instance_norm_act):
        self.calls = 0
        self.fn = fn

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.fixture
def route(monkeypatch):
    """Every device passes the route's device test; the serving launcher
    counts in ``calls``, the training Function's forward in
    ``train.calls`` and its backward in ``backward.calls``."""
    counting = _Counting()
    counting.train = _Counting(instance_norm_act_train)
    counting.backward = _Counting(instance_norm_act_backward)
    monkeypatch.setattr(layers, "_kernel_device", lambda x: True)
    monkeypatch.setattr(layers, "instance_norm_act", counting)
    monkeypatch.setattr(layers, "instance_norm_act_train", counting.train)
    monkeypatch.setattr(norm_ops, "instance_norm_act_backward",
                        counting.backward)
    return counting


def _isensee(**kw):
    torch.manual_seed(0)
    return Isensee2017(depth=5, n_base_filters=8, dtype=torch.float32, **kw)


@pytest.mark.parametrize("fold_level0", [None, (1, 1, 2)],
                         ids=["unfolded", "fold112"])
def test_route_isensee_eval_forward(route, monkeypatch, fold_level0):
    """27 norm calls an eval forward without grad, each through the
    launcher, and the same output as the composite."""
    model = _isensee(fold_level0=fold_level0).eval()
    x = _input((2, 16, 16, 16, 1), torch.float32)
    with torch.inference_mode():
        got = model(x)
    assert route.calls == 27
    monkeypatch.setattr(layers, "_kernel_device", lambda x: False)
    with torch.inference_mode():
        want = model(x)
    assert route.calls == 27
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_route_isensee_twice_counts_twice(route):
    model = _isensee().eval()
    x = _input((1, 16, 16, 16, 1), torch.float32)
    with torch.no_grad():
        model(x)
        model(x)
    assert route.calls == 54


def _train_step_grads(model, x):
    """One training forward (dropout from a seeded generator) and
    backward of a loss over the heads' output; the loss and every
    parameter's gradient."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(0)
    pred = model(x, generator=gen)
    loss = (pred * torch.linspace(-1, 1, pred.numel()).view(
        pred.shape)).sum()
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("fold_level0", [None, (1, 1, 2)],
                         ids=["unfolded", "fold112"])
def test_route_not_in_training(route, monkeypatch, fold_level0):
    """In one Isensee2017 train step the serving launcher is not called:
    its 27 norms go through the training Function, 27 forward and 27
    backward calls, and every gradient equals the composite's."""
    model = _isensee(fold_level0=fold_level0).train()
    # 32^3: the deepest level's norms see 2^3 voxels (at 1^3 x^ is 0 and
    # the level's gradients vanish)
    x = _input((2, 32, 32, 32, 1), torch.float32)
    loss, grads = _train_step_grads(model, x)
    assert route.calls == 0
    assert route.train.calls == 27 and route.backward.calls == 27
    monkeypatch.setattr(layers, "_kernel_device", lambda x: False)
    want_loss, want = _train_step_grads(model, x)
    assert route.train.calls == 27 and route.backward.calls == 27
    torch.testing.assert_close(loss, want_loss, atol=1e-5, rtol=1e-5)
    assert grads.keys() == want.keys()
    # a conv bias before a norm has a gradient of 0 up to rounding: held
    # to the scale of its block's weight gradient
    before_norm = {f"{n}.conv.bias" for n, m in model.named_modules()
                   if isinstance(m, ConvBlock) and m.norm_key}
    assert len(before_norm) == 27
    for name, g in grads.items():
        ref = want[name[:-len("bias")] + "weight" if name in before_norm
                   else name]
        err = (g - want[name]).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), name


def test_route_not_while_grad_records(route, monkeypatch):
    """An eval forward while autograd records takes the training Function,
    not the serving launcher, with the composite's output."""
    model = _isensee().eval()
    x = _input((1, 16, 16, 16, 1), torch.float32)
    with torch.enable_grad():
        got = model(x)
    assert route.calls == 0 and route.train.calls == 27
    assert got.requires_grad
    monkeypatch.setattr(layers, "_kernel_device", lambda x: False)
    with torch.enable_grad():
        want = model(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _trains_on_function(norm, x, whole=False):
    """Whether a training forward and backward of ``norm`` on x goes
    through the Function (else the composite)."""
    calls = layers.instance_norm_act_train.calls
    x = x.clone().requires_grad_(True)
    norm(x, whole=whole, activation="leaky_relu").float().sum().backward()
    assert x.grad is not None
    return layers.instance_norm_act_train.calls > calls


@pytest.mark.parametrize("group,whole,takes", [
    (None, False, True), ("ranks", False, False), ("ranks", True, True)])
def test_route_training_depth_slab(route, group, whole, takes):
    """A depth slab (``group``, not ``whole``) trains on the composite,
    whose all-reduced moments the kernel does not take; a whole level
    takes the Function."""
    norm = InstanceNorm(16, dtype=torch.float32, group=group)
    x = _input((1, 4, 4, 4, 16), torch.float32)
    if group is not None and not whole:
        # the composite's all-reduce over one rank: the identity
        norm._composite = lambda x, *a: InstanceNorm._composite(
            InstanceNorm(16, dtype=torch.float32), x, *a)
    assert _trains_on_function(norm, x, whole) is takes
    assert route.calls == 0


def test_route_training_cpu_tensor_stays_on_composite(route, monkeypatch):
    monkeypatch.setattr(layers, "_kernel_device", lambda x: x.is_cuda)
    norm = _norm(16, torch.float32)
    x = _input((1, 4, 4, 4, 16), torch.float32)
    assert not norm._takes_kernel(x, False)
    assert not _trains_on_function(norm, x)
    assert route.train.calls == route.backward.calls == 0


def test_route_training_not_while_compiling(route, monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    model = _isensee().train()
    _train_step_grads(model, _input((1, 16, 16, 16, 1), torch.float32))
    assert route.calls == route.train.calls == route.backward.calls == 0


@pytest.mark.parametrize("shape,c,dtype,norm_dtype", [
    ((1, 4, 4, 4, 4), 4, torch.float32, torch.float32),
    ((1, 4, 4, 4, 16), 16, torch.float16, torch.float16),
    ((1, 4, 4, 4, 16), 16, torch.float32, torch.bfloat16)],
    ids=["channels4", "fp16", "dtype_mismatch"])
def test_route_training_refused_shape_raises(route, monkeypatch, shape, c,
                                            dtype, norm_dtype):
    """A shape or type the kernel refuses goes to the kernel in training
    as in serving, whose checks raise (a ValueError, never a quiet
    composite): on meta tensors, the checks asked as for CUDA device 0
    (they raise before they ask the device anything)."""
    checks = norm_ops._geometry
    monkeypatch.setattr(
        norm_ops, "_geometry",
        lambda shape, dtype, _d, ss, sd, _sd, bs, bd, _bd, *rest: checks(
            shape, dtype, 0, ss, sd, 0, bs, bd, 0, *rest))
    norm = InstanceNorm(c, dtype=norm_dtype, device="meta")

    def composite(*args):
        raise AssertionError("took the composite")

    norm._composite = composite
    x = torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(
                ValueError, match="instance_norm_act"):
            norm(x, activation="leaky_relu")
    assert route.train.calls == 1 and route.calls == 1
    assert _refused(shape, c, dtype, norm_dtype)


def test_route_not_while_compiling(route, monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    model = _isensee().eval()
    with torch.no_grad():
        model(_input((1, 16, 16, 16, 1), torch.float32))
    assert route.calls == 0


def _refused(shape, c, dtype=torch.float32, out_dtype=torch.float32):
    """Whether the kernel's checks refuse x of ``shape`` on CUDA device 0
    with C = ``c`` (they raise before they ask the device anything)."""
    try:
        _geometry(shape, dtype, 0, (c,), torch.float32, 0, (c,),
                  torch.float32, 0, "leaky_relu", out_dtype)
    except ValueError as err:
        return "instance_norm_act" in str(err)
    return False


def test_route_needs_eight_channel_multiples(route):
    """The route does not screen shapes: level 0's 4 channels go to the
    kernel as well, whose checks refuse them on the card (a ValueError,
    never a quiet composite)."""
    torch.manual_seed(0)
    model = Isensee2017(depth=3, n_base_filters=4,
                        n_segmentation_levels=2,
                        dtype=torch.float32).eval()
    with torch.no_grad():
        model(_input((1, 8, 8, 8, 1), torch.float32))
    assert route.calls == 15
    assert route.calls == sum(1 for m in model.modules()
                              if isinstance(m, InstanceNorm))
    assert _refused((1, 8, 8, 8, 4), 4)


def test_route_unet_instance_norm(route):
    torch.manual_seed(0)
    model = UNet3D(depth=3, n_base_filters=8, instance_normalization=True,
                   dtype=torch.float32).eval()
    norms = sum(1 for m in model.modules() if isinstance(m, InstanceNorm))
    x = _input((2, 16, 16, 16, 1), torch.float32)
    with torch.no_grad():
        got = model(x)
    assert norms > 0 and route.calls == norms
    with torch.enable_grad():
        want = model(x)
    assert route.calls == norms
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("group,whole,takes", [
    (None, False, True), (None, True, True), ("ranks", False, False),
    ("ranks", True, True)])
def test_route_group_and_whole(monkeypatch, group, whole, takes):
    monkeypatch.setattr(layers, "_kernel_device", lambda x: True)
    norm = InstanceNorm(16, dtype=torch.float32, group=group)
    x = _input((1, 4, 4, 4, 16), torch.float32)
    with torch.no_grad():
        assert norm._takes_kernel(x, whole) is takes


def test_route_cpu_tensor_stays_on_composite():
    norm = InstanceNorm(16, dtype=torch.float32)
    with torch.no_grad():
        assert not norm._takes_kernel(
            _input((1, 4, 4, 4, 16), torch.float32), False)


@pytest.mark.parametrize("shape,c,dtype,ok", [
    ((2, 4, 4, 4, 16), 16, torch.bfloat16, True),
    ((2, 4, 4, 4, 32), 16, torch.float32, True),
    ((2, 4, 4, 4, 12), 12, torch.bfloat16, False),
    ((2, 4, 4, 4, 16), 16, torch.float16, False),
    ((2, 4, 4, 4, 24), 16, torch.bfloat16, False),
    ((0, 4, 4, 4, 16), 16, torch.bfloat16, False),
    ((1, 2, 2, 2, 2048), 2048, torch.bfloat16, False)])
def test_available(shape, c, dtype, ok):
    assert _available(shape, dtype, (c,), torch.float32) is ok
    if not ok:
        assert _refused(shape, c, dtype, dtype)


def test_route_dtype_must_match_norm(route):
    """x in another type than the norm's goes to the kernel too, which
    writes x's type and so refuses it on the card; on the CPU the result
    is in the norm's type, as the composite's."""
    norm = InstanceNorm(16, dtype=torch.bfloat16)
    x = _input((1, 4, 4, 4, 16), torch.float32)
    with torch.no_grad():
        assert norm._takes_kernel(x, False)
        assert norm(x).dtype == torch.bfloat16
        assert norm._takes_kernel(x.bfloat16(), False)
    assert route.calls == 1
    assert _refused((1, 4, 4, 4, 16), 16, torch.float32, torch.bfloat16)


@pytest.mark.parametrize("x,scale,activation", [
    (torch.zeros(2, 4, 16, device="meta"), torch.ones(16), "leaky_relu"),
    (torch.zeros(2, 4, 16, device="meta"), torch.ones(16, device="meta"),
     "leaky_relu")], ids=["meta_x", "meta_all"])
def test_kernel_entry_refuses_what_is_not_a_cuda_tensor(x, scale,
                                                        activation):
    """Off the CPU the entry point launches or raises; it never falls back
    to the plain version."""
    with pytest.raises(ValueError, match="instance_norm_act"):
        instance_norm_act(x, scale, torch.zeros_like(scale), activation)
