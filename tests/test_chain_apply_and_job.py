"""Direct unit coverage for corners previously tested only indirectly:
the propagator-chain scan (exercised via perturbative solve_sweep) and the
DynamicsJob lifecycle (exercised via backend.run)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qiskit_dynamics_tpu.ops.chain_apply import chain_apply
from qiskit_dynamics_tpu.backend.dynamics_job import DynamicsJob, JobStatus
from qiskit_dynamics_tpu.exceptions import DynamicsError


def _random_chain(rng, T, n, B, scale=0.4):
    P = rng.normal(size=(T, B, n, n)) + 1j * rng.normal(size=(T, B, n, n))
    return jnp.asarray(np.eye(n)[None, None] + scale * P / n)


class TestChainApplyBol:
    def test_matches_explicit_product(self):
        rng = np.random.default_rng(0)
        T, n, B = 7, 4, 16
        props = _random_chain(rng, T, n, B)
        y0 = jnp.asarray(
            rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
        )
        out = chain_apply(props, y0)
        expected = np.asarray(y0).copy()
        for t in range(T):
            for b in range(B):
                expected[b] = np.asarray(props[t, b]) @ expected[b]
        np.testing.assert_allclose(np.asarray(out), expected, atol=1e-12)

    def test_single_step(self):
        rng = np.random.default_rng(1)
        props = _random_chain(rng, 1, 3, 8)
        y0 = jnp.asarray(rng.normal(size=(8, 3)) + 0j)
        out = chain_apply(props, y0)
        expected = np.einsum("bij,bj->bi", np.asarray(props[0]), np.asarray(y0))
        np.testing.assert_allclose(np.asarray(out), expected, atol=1e-12)

    def test_empty_chain_rejected(self):
        with pytest.raises(ValueError, match="T >= 1"):
            chain_apply(
                jnp.zeros((0, 8, 2, 2), dtype=complex),
                jnp.zeros((8, 2), dtype=complex),
            )

    def test_grad_matches_fd(self):
        """Autodiff gradient in both props and y0 vs finite differences."""
        rng = np.random.default_rng(2)
        T, n, B = 4, 3, 8
        props0 = _random_chain(rng, T, n, B)
        y0 = jnp.asarray(rng.normal(size=(B, n)) + 0j)

        def loss(a):
            out = chain_apply(props0 * a, y0 * (2.0 - a))
            return jnp.sum(jnp.abs(out) ** 2)

        g = float(jax.grad(loss)(0.9))
        eps = 1e-6
        fd = (float(loss(0.9 + eps)) - float(loss(0.9 - eps))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-6)


class TestDynamicsJob:
    def _job(self):
        calls = []

        def fn(job_id):
            calls.append(job_id)
            return {"id": job_id, "n_calls": len(calls)}

        return DynamicsJob(backend="fake-backend", job_id="jid-1", fn=fn), calls

    def test_lifecycle(self):
        job, calls = self._job()
        assert job.job_id() == "jid-1"
        assert job.backend() == "fake-backend"
        assert job.status() == JobStatus.INITIALIZING
        with pytest.raises(DynamicsError, match="not been submitted"):
            job.result()
        job.submit()
        assert job.status() == JobStatus.DONE
        assert job.result() == {"id": "jid-1", "n_calls": 1}
        assert calls == ["jid-1"]
        steps = job.time_per_step()
        assert set(steps) >= {"RUNNING", "COMPLETED"}
        assert steps["COMPLETED"] >= steps["RUNNING"]

    def test_double_submit_rejected(self):
        job, _ = self._job()
        job.submit()
        with pytest.raises(DynamicsError, match="already been submitted"):
            job.submit()
