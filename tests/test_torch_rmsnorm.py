"""RMSNorm: the port's plain version of the kernel against the reference's
Pallas kernel in interpret mode, on the same inputs (the shapes of
``tests/test_kernels_rmsnorm.py``).  bf16 within 2e-2 abs, as the
reference's tests.  f32 within 1e-6 abs plus 1e-6 relative: the two
packages sum the squares in another order and round rsqrt apart, each
about one f32 ulp (1.2e-7 relative) of the statistic, and outputs reach
|15| here, so an absolute 1e-6 alone would sit under one ulp of the
largest outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rmsnorm as jax_rmsnorm
from repro_torch.kernels.rmsnorm import kernel as rmod
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

SHAPES = [(128, 256), (33, 100), (4, 8, 64), (1, 512), (256, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-6),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
RTOL = {"f32": 1e-6, "bf16": 0.0}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_rmsnorm_matches_reference_kernel(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    want = jax_rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                       block_rows=32, interpret=True)
    before = rmod.LAUNCHES
    got = rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert rmod.LAUNCHES == before          # CPU: no kernel launch
    assert got.dtype == tdt and tuple(got.shape) == shape
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(want - got.float().numpy())
    bound = tol + RTOL[dtype] * np.abs(want)
    assert (err <= bound).all(), (shape, dtype, float(err.max()))


def test_kernel_wrapper_checks_shapes():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        rmod.rmsnorm_kernel(x, torch.ones(7))
    with pytest.raises(ValueError):
        rmod.rmsnorm_kernel(x.reshape(-1), torch.ones(8))
    assert torch.equal(rmod.rmsnorm_kernel(x, torch.ones(8)),
                       rmsnorm_ref(x, torch.ones(8)))
