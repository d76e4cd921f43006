"""The port's direct-form low-pass filters (``alg_tpu_torch/alg/filters.py``)
against ``alg_tpu.alg.filters`` on the same inputs: none, down_up and
gaussian_blur, 4D and 5D, the no-op exits and the kernel-size coercion; the
operator form the denoise loops use against the direct form; and the resize
operator against ``F.interpolate(bilinear, antialias=True,
align_corners=False)``, the reference's own call.

Bounds: 1e-6 against ``alg_tpu`` (both fp32; the convolution and the resize
sum in another order) and against ``F.interpolate``; the operator form 1e-5
(fp32 matmuls over a whole row against a convolution's few taps)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from alg_tpu.alg import filters as JF

from alg_tpu_torch.alg import filters as TF
from alg_tpu_torch.alg.matrices import apply_filter_matrices, bilinear_resize_matrix, filter_matrices

from torch_port_common import one_thread


ATOL = 1e-6

FILTERS = {
    "gaussian-relative-ks": ("gaussian_blur", dict(blur_sigma=1.5, blur_kernel_size=0.3)),
    "gaussian-int-even-ks": ("gaussian_blur", dict(blur_sigma=2.0, blur_kernel_size=4)),
    "gaussian-ks-past-edge": ("gaussian_blur", dict(blur_sigma=3.0, blur_kernel_size=15)),
    "down-up-quarter": ("down_up", dict(resize_factor=0.25)),
    "down-up-0.6": ("down_up", dict(resize_factor=0.6)),
}
SHAPES = {"4d": (2, 3, 17, 23), "5d": (1, 3, 2, 9, 12)}


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("case", list(FILTERS), ids=list(FILTERS))
def test_filter_matches_alg_tpu(case, shape):
    kind, kw = FILTERS[case]
    x = np.random.RandomState(0).randn(*SHAPES[shape]).astype(np.float32)
    ref = np.asarray(JF.apply_low_pass_filter(jnp.asarray(x), kind, **kw))
    out = TF.apply_low_pass_filter(torch.from_numpy(x), kind, **kw)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind,kw", [("none", {}), ("down_up", dict(resize_factor=1.0)),
                                     ("gaussian_blur", dict(blur_sigma=0, blur_kernel_size=5))],
                         ids=["none", "down-up-at-1", "gaussian-at-sigma-0"])
def test_noop_settings_return_the_input(kind, kw):
    x = torch.randn(1, 3, 8, 8)
    j = jnp.asarray(x.numpy())
    assert TF.apply_low_pass_filter(x, kind, **kw) is x
    assert JF.apply_low_pass_filter(j, kind, **kw) is j


def test_unknown_filter_raises():
    with pytest.raises(ValueError, match="filter_type"):
        TF.apply_low_pass_filter(torch.zeros(1, 1, 4, 4), "box", blur_sigma=1.0)


@pytest.mark.parametrize("ks,height,want", [(0.1, 480, 49), (0.1, 32, 3), (0.01, 32, 1), (4, 32, 5), (7, 32, 7)])
def test_kernel_size_coercion(ks, height, want):
    """A float is relative to H (at least 1), an int absolute; even sizes
    become odd: the blur with that size equals the blur with ``want``."""
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 1, height, 16).astype(np.float32))
    a = TF.apply_low_pass_filter(x, "gaussian_blur", blur_sigma=2.0, blur_kernel_size=ks)
    b = TF.apply_low_pass_filter(x, "gaussian_blur", blur_sigma=2.0, blur_kernel_size=want)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(FILTERS), ids=list(FILTERS))
def test_operator_form_matches_the_direct_form(case):
    """``filter_matrices`` + ``apply_filter_matrices`` (the loops' form) equal
    the direct filter."""
    kind, kw = FILTERS[case]
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 2, 24, 40).astype(np.float32))
    m_h, m_w = filter_matrices(kind, 24, 40, **kw)
    got = apply_filter_matrices(x, torch.from_numpy(m_h), torch.from_numpy(m_w))
    torch.testing.assert_close(got, TF.apply_low_pass_filter(x, kind, **kw), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(480, 120), (720, 180), (60, 15), (15, 60), (23, 7), (7, 23), (9, 9)])
def test_resize_operator_matches_torch_interpolate(n_in, n_out):
    """The 1D operator behind ``down_up_matrix`` against torch's antialiased
    bilinear resize of a one-row image, both directions."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 1, n_in, 5).astype(np.float32))
    ref = F.interpolate(x, size=(n_out, 5), mode="bilinear", align_corners=False, antialias=True)
    got = torch.einsum("oh,bchw->bcow", torch.from_numpy(bilinear_resize_matrix(n_in, n_out)), x)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
