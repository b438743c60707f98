"""The lockstep Triton kernel compiled for the card (no interpreter).

Run on a GPU with ``QDT_TEST_GPU=1 python -m pytest -m gpu tests/``; the
fixture skips these tests where JAX finds no GPU.
"""
import numpy as np
import pytest
import jax

from test_batched_linalg import _lockstep_problem

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: QDT_TEST_GPU=1 python -m pytest -m gpu tests/")
    return jax.devices()[0]


@pytest.mark.parametrize("n,mode", [(16, "constant"), (27, "table"), (4, "t_eval")])
def test_compiled_kernel_matches_xla_twin(gpu, n, mode):
    from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep

    k, B, t0, tf = 2, 256, 0.25, 1.5
    rng, H0, ops, omega, freqs, y0 = _lockstep_problem(n, k, B, seed=n)
    kw = dict(tf=tf, t0=t0, atol=1e-6, rtol=1e-6, h0=0.05, tile_b=16, max_steps=256)
    if mode == "table":
        amps = rng.normal(size=(k, 5, B)) + 1j * rng.normal(size=(k, 5, B))
        kw["env_dt"] = (tf - t0) / 5
    else:
        amps = rng.normal(size=(k, B)) + 1j * rng.normal(size=(k, B))
    if mode == "t_eval":
        kw["eval_ts"] = (0.4, 0.9, tf - t0)
    args = (H0, ops, omega, freqs, amps, y0)
    out_t = sweep_dopri5_lockstep(*args, engine="triton", **kw)
    out_x = sweep_dopri5_lockstep(*args, engine="xla", **kw)
    pairs = zip(out_t, out_x) if mode == "t_eval" else [(out_t, out_x)]
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        # populations: the engines' f32 error estimates steer their step
        # sizes apart, so states differ by the integration (phase) error
        np.testing.assert_allclose(np.abs(a) ** 2, np.abs(b) ** 2, atol=2e-5)


def test_engine_choice_on_the_card(gpu):
    from qiskit_dynamics_tpu.ops.adaptive_sweep import lockstep_engine

    assert lockstep_engine() == "triton"
