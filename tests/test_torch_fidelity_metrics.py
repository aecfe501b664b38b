"""The port's data-fidelity / dual updates and metrics against the JAX
package.  Tolerance rtol 1e-5 (f32 elementwise arithmetic in another
order; SSIM's banded products sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.ops import blocks as jblocks
from lrs_pnp_dip_tpu.ops import fidelity as jfid
from lrs_pnp_dip_tpu.ops import metrics as jmetrics
from lrs_pnp_dip_tpu.ops.ssim import ssim as j_ssim
from lrs_pnp_dip_tpu_torch.ops import blocks as tblocks
from lrs_pnp_dip_tpu_torch.ops import fidelity as tfid
from lrs_pnp_dip_tpu_torch.ops import metrics as tmetrics
from lrs_pnp_dip_tpu_torch.ops.ssim import ssim as t_ssim

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

RTOL = 1e-5


@pytest.mark.parametrize("geom", [(144, 16, 6, 6), (100, 20, 6, 4)])
def test_fidelity_and_duals_match(geom):
    P, B, bb, stride = geom
    rng = np.random.default_rng(P)
    g_t = tblocks.block_grid((P, B), bb, stride)
    g_j = jblocks.block_grid((P, B), bb, stride)
    Y = rng.standard_normal((P, B)).astype(np.float32)
    mask = (rng.random((P, 1)) > 0.2).astype(np.float32).repeat(B, axis=1)
    phi = rng.standard_normal((g_t.n_blocks, bb * bb)).astype(np.float32)
    U, l1, l2 = (rng.standard_normal((P, B)).astype(np.float32) for _ in range(3))
    args = (Y, mask, phi, U, l1, l2)
    X_t, im_t = tfid.data_fidelity_update(
        *(torch.from_numpy(a) for a in args), g_t, 0.5, 0.1, 0.2
    )
    X_j, im_j = jfid.data_fidelity_update(
        *(jnp.asarray(a) for a in args), g_j, 0.5, 0.1, 0.2
    )
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), rtol=RTOL, atol=1e-6)
    d_t = tfid.dual_updates(
        torch.from_numpy(l1), torch.from_numpy(l2), X_t, im_t, torch.from_numpy(U), 0.1, 0.2
    )
    d_j = jfid.dual_updates(jnp.asarray(l1), jnp.asarray(l2), X_j, im_j, jnp.asarray(U), 0.1, 0.2)
    for a, b in zip(d_t, d_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)


def test_metrics_match():
    rng = np.random.default_rng(7)
    clean = rng.random((3, 12, 10, 16)).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    c, n = torch.from_numpy(clean), torch.from_numpy(noisy)
    np.testing.assert_allclose(
        float(tmetrics.mpsnr(c[0], n[0])), float(jmetrics.mpsnr(clean[0], noisy[0])), rtol=RTOL
    )
    np.testing.assert_allclose(
        float(tmetrics.psnr_ref(c, n)), float(jmetrics.psnr_ref(clean, noisy)), rtol=RTOL
    )
    np.testing.assert_allclose(
        float(tmetrics.batch_mpsnr(c, n)), float(jmetrics.batch_mpsnr(clean, noisy)), rtol=RTOL
    )


@pytest.mark.parametrize("shape", [(36, 36, 8), (12, 10, 5)])
def test_ssim_matches(shape):
    rng = np.random.default_rng(shape[0])
    a = rng.random(shape).astype(np.float32)
    b = (a + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    ours = float(t_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(j_ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    per = t_ssim(torch.from_numpy(a)[None], torch.from_numpy(b)[None], size_average=False)
    np.testing.assert_allclose(
        per.numpy(), np.asarray(j_ssim(jnp.asarray(a)[None], jnp.asarray(b)[None], size_average=False)),
        rtol=RTOL,
    )
