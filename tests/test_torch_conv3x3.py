"""The conv port (ops/conv3x3.py) against the JAX package's Pallas conv
kernels run in interpret mode: K1 ``pallas_conv._conv3x3_fwd``, K2
``pallas_conv_flat._conv3x3_flat_fwd`` and ``conv3x3_chain``. fp32 on the
CPU, where every entry point runs its plain version; tolerance atol 1e-4
(fp32 sums in another order). The CUDA kernel itself runs only on the card
(chip_smoke.py); here the tests pin that a CUDA-less build or a non-CPU
tensor raises instead of falling back."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.ops import pallas_conv  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_conv_flat  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as ops  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import cuda_lib  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
ACTIVATIONS = [("relu", 0.01), ("leaky_relu", 0.3), ("none", 0.3)]


def _inputs(B=1, D=5, H=8, W=12, ci=16, co=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, D, H, W, ci)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 3, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return x, w, b


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("activation,slope", ACTIVATIONS)
def test_conv3x3_matches_pallas_halo_slab_kernel(activation, slope):
    x, w, b = _inputs()
    want = pallas_conv._conv3x3_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        activation=activation, negative_slope=slope, interpret=True)
    got = ops.conv3x3(*_torch(x, w, b), activation, slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("activation,slope", ACTIVATIONS)
def test_conv3x3_flat_matches_pallas_flat_kernel(activation, slope):
    x, w, b = _inputs(B=2, D=4, H=6, W=9, ci=8, co=16, seed=1)
    want = pallas_conv_flat._conv3x3_flat_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        activation=activation, negative_slope=slope, interpret=True)
    got = ops.conv3x3_flat(*_torch(x, w, b), activation, slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("activations", [("relu", "leaky_relu"),
                                         ("none", "relu")])
def test_conv3x3_chain_matches_pallas_chain(activations):
    x, w1, b1 = _inputs(D=3, H=5, W=7, ci=8, co=16, seed=2)
    _, w2, b2 = _inputs(ci=16, co=8, seed=3)
    want = pallas_conv_flat.conv3x3_chain(
        jnp.asarray(x), (jnp.asarray(w1), jnp.asarray(w2)),
        (jnp.asarray(b1), jnp.asarray(b2)), activations,
        negative_slope=0.3, interpret=True)
    xt, w1t, b1t, w2t, b2t = _torch(x, w1, b1, w2, b2)
    got = ops.conv3x3_chain(xt, (w1t, w2t), (b1t, b2t), activations, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    x, w, b = _torch(*_inputs(ci=8, co=8))
    before = (ops.conv3x3.launches, ops.conv3x3_flat.launches)
    ref = ops.conv3x3_reference(x, w, b, "relu")
    torch.testing.assert_close(ops.conv3x3(x, w, b, "relu"), ref)
    torch.testing.assert_close(ops.conv3x3_flat(x, w, b, "relu", 0.01), ref)
    assert (ops.conv3x3.launches, ops.conv3x3_flat.launches) == before


@pytest.mark.parametrize("ci,co,ok", [(8, 8, True), (32, 64, True),
                                      (24, 40, True), (1, 32, False),
                                      (4, 8, False), (12, 8, False),
                                      (16, 20, False)])
def test_gate(ci, co, ok):
    assert ops.conv3x3_available(ci, co) is ok
    if not ok:
        x, w, b = _torch(*_inputs(ci=ci, co=co))
        with pytest.raises(ValueError, match="conv3x3_available"):
            ops.conv3x3_flat(x, w, b)


def test_non_cpu_tensors_raise_instead_of_falling_back():
    x, w, b = (t.to("meta") for t in _torch(*_inputs(ci=8, co=8)))
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.conv3x3(x, w, b)


def test_kernel_operand_checks():
    t = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_lib.require_cuda_bf16("k", x=t)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build()


def test_library_name_follows_the_sources():
    path = cuda_lib.library_path()
    assert path.parent == cuda_lib.BUILD_DIR
    assert path == cuda_lib.library_path()
    assert {p.name for p in cuda_lib.CSRC.glob("*.cu")} == {
        "conv3x3.cu", "dec0.cu", "instance_norm.cu", "keras_adam.cu"}
