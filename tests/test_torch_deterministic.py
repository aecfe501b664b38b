"""The pieces that make the port's DIP fits and BM3D repeat bit for bit on
the card, held here on the CPU against what they replace and against the
JAX package.

  * Reflection padding (``models/common.py:pad_input``): the forward is
    ``F.pad(mode="reflect")`` bit for bit; the backward folds the padded
    gradient back in a fixed order, at most three terms per entry and axis
    in another order than ``F.pad``'s, so it agrees to 1e-6 and exactly on
    dyadic inputs (sums of a few multiples of 2^-4 are exact in f32).  The
    np.pad branch (axes no longer than the pad), slices and ``cat``, is held
    to the ``index_select`` it replaces the same way.
  * UNet3D's 2x2x2 max pooling as a maximum over each window's 8 entries:
    ``F.max_pool3d`` forward and backward, ties to the first entry.
  * Linear x2 upsampling as fixed-weight sums: against
    ``F.interpolate(align_corners=False)`` to 1e-6 forward and backward, and
    against ``jax.image.resize`` (``tests/test_torch_zoo.py``).
  * ``deterministic_cudnn``: the flags inside, the caller's after, and the
    DIP fits and ``fit`` running under it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lrs_pnp_dip_tpu_torch.models import common as tcommon
from lrs_pnp_dip_tpu_torch.ops.nlm import np_pad_index
from lrs_pnp_dip_tpu_torch.solvers import DipFit, FitConfig, fit
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig
from lrs_pnp_dip_tpu_torch.utils.device import deterministic_cudnn

torch.set_num_threads(1)


def _inputs(shape, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:
        x = rng.integers(-64, 64, shape) / 16.0
        g = rng.integers(-64, 64, shape) / 16.0
    else:
        x, g = rng.standard_normal(shape), rng.standard_normal(shape)
    return torch.tensor(x, dtype=torch.float32), g


def _grad(fn, x, seed):
    x = x.clone().requires_grad_(True)
    out = fn(x)
    g = torch.tensor(np.random.default_rng(seed).integers(-64, 64, out.shape) / 16.0, dtype=torch.float32)
    (out * g).sum().backward()
    return out.detach(), x.grad


def _old_np_reflect(x, pad):
    """The index_select form the np.pad branch had."""
    for axis in range(2, x.ndim):
        x = x.index_select(axis, np_pad_index(x.shape[axis], pad, "reflect", x.device))
    return x


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "normal"])
@pytest.mark.parametrize(
    "shape,pad",
    [((2, 3, 9, 7), 1), ((1, 4, 6, 11), 3), ((2, 2, 5, 6, 7), 1), ((1, 3, 4, 5, 9), 2)],
    ids=["4d-pad1", "4d-pad3", "5d-pad1", "5d-pad2"],
)
def test_reflection_pad_is_f_pad(shape, pad, dyadic):
    x, _ = _inputs(shape, sum(shape) + pad, dyadic)
    widths = (pad, pad) * (len(shape) - 2)
    out, grad = _grad(lambda t: tcommon.pad_input(t, pad, "reflection"), x, 1)
    ref_out, ref_grad = _grad(lambda t: F.pad(t, widths, mode="reflect"), x, 1)
    assert torch.equal(out, ref_out)
    if dyadic:
        assert torch.equal(grad, ref_grad)
    else:
        torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "normal"])
@pytest.mark.parametrize(
    "shape,pad",
    [((2, 3, 1, 1), 1), ((1, 2, 2, 5), 2), ((1, 2, 3, 1, 4), 3), ((1, 1, 2, 2, 2), 4)],
    ids=["4d-1x1", "4d-2x5-pad2", "5d-pad3", "5d-pad4"],
)
def test_reflection_pad_short_axes_is_np_pad(shape, pad, dyadic):
    """Axes no longer than the pad: np.pad's reflect (a 1x1 map repeats),
    as the index_select it replaces and as numpy computes it."""
    x, _ = _inputs(shape, sum(shape) + pad, dyadic)
    out, grad = _grad(lambda t: tcommon.pad_input(t, pad, "reflection"), x, 2)
    ref_out, ref_grad = _grad(lambda t: _old_np_reflect(t, pad), x, 2)
    assert torch.equal(out, ref_out)
    widths = [(0, 0), (0, 0)] + [(pad, pad)] * (len(shape) - 2)
    assert np.array_equal(out.numpy(), np.pad(x.numpy(), widths, mode="reflect"))
    if dyadic:
        assert torch.equal(grad, ref_grad)
    else:
        torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 4), (1, 2, 3, 4, 5), (1, 1, 1, 2, 1)])
def test_linear_upsampling_is_interpolate(shape):
    """Forward and backward against torch's align_corners=False at a factor
    of 2 (bilinear for 4-D, trilinear for 5-D), length-1 axes included."""
    x, _ = _inputs(shape, 5, False)
    mode = "bilinear" if len(shape) == 4 else "trilinear"
    out, grad = _grad(tcommon.upsample_linear2x, x, 3)
    ref_out, ref_grad = _grad(lambda t: F.interpolate(t, scale_factor=2, mode=mode, align_corners=False), x, 3)
    torch.testing.assert_close(out, ref_out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-6, atol=1e-6)
    if len(shape) == 4:
        assert torch.equal(tcommon.upsample2x(x, "bilinear"), out)


def test_trilinear_upsampling_is_jax_image_resize():
    v = np.random.default_rng(7).standard_normal((2, 4, 3, 5, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(v), (2, 8, 6, 10, 3), method="trilinear"))
    got = tcommon.upsample_linear2x(torch.from_numpy(v).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_deterministic_cudnn_restores_the_callers_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        with deterministic_cudnn():
            assert (cudnn.deterministic, cudnn.benchmark) == (True, False)
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with pytest.raises(RuntimeError, match="inside"):
            with deterministic_cudnn():
                raise RuntimeError("inside")
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


class _FlagProbe(torch.nn.Module):
    """A one-parameter net that records cuDNN's flags at each forward."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.seen = []

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w.fill_(1.0)

    def forward(self, x):
        self.seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))
        return self.w * x


def test_fits_and_captures_run_under_deterministic_cudnn():
    """DipFit (host-stepped and chunked) and fit see deterministic cuDNN
    without autotuning, and leave the caller's flags.  (A Captured's warm-up
    and capture run on the card only: tests/test_torch_cuda.py.)"""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        x = torch.rand((1, 3, 3, 2))
        net = _FlagProbe()
        DipFit(net, DipConfig(num_iter=3, buffer_size=2, patience=5))(x, x, torch.ones_like(x))
        DipFit(net, DipConfig(num_iter=3, buffer_size=2, patience=5))(x, x, torch.ones_like(x), chunk=2)
        fit(net, None, x, x, config=FitConfig(num_iter=2), device="cpu")
        assert net.seen and set(net.seen) == {(True, False)}
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


@pytest.mark.parametrize("shape", [(2, 3, 4, 6, 8), (1, 2, 5, 7, 3)])
def test_max_pool3d_is_f_max_pool3d(shape):
    from lrs_pnp_dip_tpu_torch.models.unet3d import max_pool3d_2

    x, _ = _inputs(shape, 9, False)
    out, grad = _grad(max_pool3d_2, x, 4)
    ref_out, ref_grad = _grad(lambda t: F.max_pool3d(t, 2, 2), x, 4)
    assert torch.equal(out, ref_out) and torch.equal(grad, ref_grad)
    ties = torch.zeros((1, 1, 2, 2, 2), requires_grad=True)  # every entry a maximum
    max_pool3d_2(ties).sum().backward()
    assert ties.grad.flatten().tolist() == [1.0] + [0.0] * 7
