"""Tests for the multi-chip parallel layer (8 virtual CPU devices, conftest)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qiskit_dynamics_tpu.parallel import (
    make_mesh,
    data_mesh,
    pvmap,
    sharded_sweep,
    propagator_scan,
    sharded_propagator_scan,
    DATA_AXIS,
    TIME_AXIS,
)


def test_make_mesh_default():
    mesh = data_mesh()
    assert mesh.shape[DATA_AXIS] == len(jax.devices())


def test_make_mesh_2d():
    mesh = make_mesh((4, 2), (DATA_AXIS, TIME_AXIS))
    assert mesh.shape[DATA_AXIS] == 4
    assert mesh.shape[TIME_AXIS] == 2


def test_pvmap_matches_vmap():
    def f(x):
        return jnp.sin(x) ** 2 + x

    batch = jnp.linspace(0.0, 1.0, 24)
    out = pvmap(f)(batch)
    np.testing.assert_allclose(np.asarray(out), np.asarray(jax.vmap(f)(batch)), atol=1e-12)


@pytest.mark.parametrize("batch_size", [5, 8, 13])
def test_pvmap_non_divisible_batches(batch_size):
    def f(x):
        return {"y": 2.0 * x["a"] + x["b"].sum()}

    batch = {
        "a": jnp.arange(batch_size, dtype=float),
        "b": jnp.ones((batch_size, 3)),
    }
    out = pvmap(f)(batch)
    assert out["y"].shape == (batch_size,)
    np.testing.assert_allclose(np.asarray(out["y"]), 2.0 * np.arange(batch_size) + 3.0)


def test_sharded_sweep_complex_outputs():
    # complex values must survive the cjit boundary
    def f(amp):
        return jnp.exp(1j * amp)

    amps = jnp.linspace(0.0, np.pi, 16)
    out = sharded_sweep(f, amps)
    np.testing.assert_allclose(np.asarray(out), np.exp(1j * np.linspace(0, np.pi, 16)), atol=1e-12)


def test_propagator_scan_orders():
    rng = np.random.default_rng(42)
    T, n = 16, 4
    props = rng.standard_normal((T, n, n)) + 1j * rng.standard_normal((T, n, n))
    props = jnp.asarray(props)
    out = propagator_scan(props)
    expected = props[0]
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(expected))
    for k in range(1, T):
        expected = props[k] @ expected
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(expected), atol=1e-10)


def test_sharded_propagator_scan_matches_single_device():
    rng = np.random.default_rng(7)
    T, n = 32, 4
    # near-unitary propagators to keep products well-conditioned
    props = np.stack(
        [np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))[0]
         for _ in range(T)]
    )
    props = jnp.asarray(props)
    mesh = make_mesh(axis_names=(TIME_AXIS,))
    out = sharded_propagator_scan(props, mesh=mesh)
    ref = propagator_scan(props)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_sharded_propagator_scan_divisibility_error():
    props = jnp.tile(jnp.eye(2, dtype=complex), (9, 1, 1))
    with pytest.raises(ValueError):
        sharded_propagator_scan(props)


def test_pshard_batch_matches_direct():
    from qiskit_dynamics_tpu.parallel import pshard_batch

    def fn_batch(xs):  # batch-level function
        return jnp.cumsum(jnp.ones_like(xs)) * 0 + xs * 2.0

    xs = jnp.arange(20.0)
    out = pshard_batch(fn_batch)(xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(xs) * 2.0)


def test_sharded_fused_schedule_batch():
    """Schedule-batch envelope tables sharded across the data mesh: each
    device runs the fused adaptive table engine on its shard; results match
    the serial fused path at the engines' accuracy floor."""
    from qiskit_dynamics_tpu import Solver
    from qiskit_dynamics_tpu.pulse import Schedule, Play, DriveChannel, Gaussian
    from qiskit_dynamics_tpu.parallel import pshard_batch
    from qiskit_dynamics_tpu.signals import DiscreteSignal
    from qiskit_dynamics_tpu.solvers.fused_sweep import fused_adaptive_sweep_solve

    nu, r, dt = 5.0, 0.1, 0.1
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * r * X / 2],
        hamiltonian_channels=["d0"],
        channel_carrier_freqs={"d0": nu},
        dt=dt,
        rotating_frame=2 * np.pi * nu * Z / 2,
    )
    y0 = np.array([1.0, 0.0], dtype=complex)
    duration, tf = 40, 4.0
    amps = np.linspace(0.1, 0.9, 16)
    scheds = []
    for amp in amps:
        s = Schedule(name=f"a{amp}")
        s.append(Play(Gaussian(duration=duration, amp=float(amp), sigma=8), DriveChannel(0)))
        scheds.append(s)

    serial = solver.solve(
        t_span=[0.0, tf], y0=y0, signals=scheds, method="fused_dopri5",
        interpret=True, convert_results=False,
    )
    serial_y = np.stack([np.asarray(res.y[-1]) for res in serial])

    # sharded: per-lane sample tables, leading (batch) axis split over devices
    samples = np.stack(
        [np.asarray(solver._schedule_converter.get_signals(s)[0].samples) for s in scheds]
    )[:, None, :]  # (B, n_channels=1, S)

    def shard_fn(p):
        def signals_fn(q):
            return [DiscreteSignal(dt=dt, samples=q[0], carrier_freq=nu)]

        return fused_adaptive_sweep_solve(
            solver.model, signals_fn, p, t_span=(0.0, tf), y0=y0,
            envelope_resolution=duration, tile_b=8,
        )

    out = pshard_batch(shard_fn, mesh=data_mesh())(jnp.asarray(samples))
    # lockstep step control is shared per group: different groupings
    # (tile_b=8 per shard vs the default serial group) take slightly
    # different f32 step sequences, so agreement is at the engines'
    # accuracy floor, not exact
    np.testing.assert_allclose(np.asarray(out), serial_y, atol=1e-4)


def test_solver_fused_schedule_mesh_option():
    """Solver.solve(method='fused_dopri5', mesh=...) shards the schedule
    batch across the device mesh (backend-level multi-device serving)."""
    from qiskit_dynamics_tpu import Solver
    from qiskit_dynamics_tpu.pulse import Schedule, Play, DriveChannel, Gaussian

    nu, r, dt = 5.0, 0.1, 0.1
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * r * X / 2],
        hamiltonian_channels=["d0"],
        channel_carrier_freqs={"d0": nu},
        dt=dt,
        rotating_frame=2 * np.pi * nu * Z / 2,
    )
    y0 = np.array([1.0, 0.0], dtype=complex)
    scheds = []
    for amp in np.linspace(0.2, 0.8, 12):  # 12: exercises pad-to-16 trimming
        s = Schedule(name=f"a{amp}")
        s.append(Play(Gaussian(duration=40, amp=float(amp), sigma=8), DriveChannel(0)))
        scheds.append(s)

    serial = solver.solve(
        t_span=[0.0, 4.0], y0=y0, signals=scheds, method="fused_dopri5",
        interpret=True, convert_results=False,
    )
    sharded = solver.solve(
        t_span=[0.0, 4.0], y0=y0, signals=scheds, method="fused_dopri5",
        convert_results=False, mesh=data_mesh(), tile_b=8,
    )
    for a, b in zip(serial, sharded):
        # different groupings -> agreement at the engines' accuracy floor
        np.testing.assert_allclose(
            np.asarray(a.y[-1]), np.asarray(b.y[-1]), atol=1e-4
        )


def test_sharded_fused_sweep_gradient_matches_serial():
    """Gradients flow through shard_map + the fused custom-VJP sweep: the
    mesh-sharded gradient must equal the single-device gradient exactly."""
    import jax
    import jax.numpy as jnp
    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve
    from qiskit_dynamics_tpu.parallel import pshard_batch
    from qiskit_dynamics_tpu import Signal

    solver, w1 = cr_solver(dim=2)
    y0 = np.zeros(4, dtype=complex)
    y0[0] = 1.0

    def signals_fn(amp):
        return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

    def batch_fn(amps):
        return fused_sweep_solve(
            solver.model, signals_fn, amps, t_span=(0.0, 2.0), max_dt=0.5,
            y0=y0, rwa_signal_map=solver._rwa_signal_map,
        )

    sharded = pshard_batch(batch_fn)
    amps = jnp.linspace(0.1, 1.0, 16)
    np.testing.assert_allclose(
        np.asarray(sharded(amps)), np.asarray(batch_fn(amps)), atol=1e-13
    )
    loss_sh = lambda a: jnp.mean(jnp.abs(sharded(a)[:, 1]) ** 2)
    loss_ref = lambda a: jnp.mean(jnp.abs(batch_fn(a)[:, 1]) ** 2)
    np.testing.assert_allclose(
        np.asarray(jax.grad(loss_sh)(amps)),
        np.asarray(jax.grad(loss_ref)(amps)),
        atol=1e-15,
    )


def test_fused_sweep_solve_mesh_kwarg():
    """fused_sweep_solve(mesh=...) shards the batch internally and matches
    the serial call exactly (the fixed-step engine is member-independent)."""
    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve
    from qiskit_dynamics_tpu import Signal
    from qiskit_dynamics_tpu.exceptions import DynamicsError

    solver, w1 = cr_solver(dim=2)
    y0 = np.zeros(4, dtype=complex)
    y0[0] = 1.0

    def signals_fn(amp):
        return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

    kw = dict(
        t_span=(0.0, 2.0), max_dt=0.5, y0=y0,
        rwa_signal_map=solver._rwa_signal_map,
    )
    amps = jnp.linspace(0.1, 1.0, 12)  # 12: exercises the pad-to-16 trim
    serial = fused_sweep_solve(solver.model, signals_fn, amps, **kw)
    sharded = fused_sweep_solve(
        solver.model, signals_fn, amps, mesh=data_mesh(), **kw
    )
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(serial), atol=1e-13)

    # gradients flow through the sharded path (AD under shard_map)
    loss_sh = lambda a: jnp.mean(
        jnp.abs(
            fused_sweep_solve(solver.model, signals_fn, a, mesh=data_mesh(), **kw)[:, 1]
        )
        ** 2
    )
    loss_ref = lambda a: jnp.mean(
        jnp.abs(fused_sweep_solve(solver.model, signals_fn, a, **kw)[:, 1]) ** 2
    )
    np.testing.assert_allclose(
        np.asarray(jax.grad(loss_sh)(amps)),
        np.asarray(jax.grad(loss_ref)(amps)),
        atol=1e-15,
    )

    # df32 is host-orchestrated: mesh must raise
    with pytest.raises(DynamicsError, match="df32"):
        fused_sweep_solve(
            solver.model, signals_fn, amps, mesh=data_mesh(),
            precision="df32", t_span=(0.0, 2.0), max_dt=0.5, y0=y0,
            rwa_signal_map=solver._rwa_signal_map,
        )


def test_fused_adaptive_sweep_solve_mesh_kwarg():
    """fused_adaptive_sweep_solve(mesh=...) shards the batch internally;
    per-shard lockstep grouping matches the serial grouping at tile_b=2 (the
    XLA engine, the CPU path, takes any group size), so results agree to f32
    roundoff."""
    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
    from qiskit_dynamics_tpu import Signal

    solver, w1 = cr_solver(dim=2)
    y0 = np.zeros(4, dtype=complex)
    y0[0] = 1.0

    def signals_fn(amp):
        return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

    kw = dict(
        t_span=(0.0, 2.0), y0=y0, atol=1e-8, rtol=1e-8, tile_b=2,
        rwa_signal_map=solver._rwa_signal_map,
    )
    amps = jnp.linspace(0.1, 1.0, 16)
    serial = fused_adaptive_sweep_solve(solver.model, signals_fn, amps, **kw)
    sharded = fused_adaptive_sweep_solve(
        solver.model, signals_fn, amps, mesh=data_mesh(), **kw
    )
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(serial), atol=5e-7)


def test_adaptive_mesh_gradient_matches_single_device():
    """jit(grad(loss)) through fused_adaptive_sweep_solve(mesh=...): the
    recorded-grid replay adjoint runs per-shard under shard_map and the
    sharded gradient equals the single-device gradient (the jit wrapper is
    required — jax cannot evaluate the custom-VJP call eagerly inside
    shard_map; documented in the mesh= docstring)."""
    import jax
    import jax.numpy as jnp
    from qiskit_dynamics_tpu import Signal, parallel
    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve

    solver, w1 = cr_solver(dim=2)
    y0 = np.zeros(4, dtype=complex)
    y0[0] = 1.0
    mesh = parallel.data_mesh(4)
    amps = jnp.linspace(0.2, 1.0, 8)

    def loss(a, use_mesh):
        yf = fused_adaptive_sweep_solve(
            solver.model,
            lambda amp: [Signal(lambda t: amp * 0.02, carrier_freq=w1)],
            a, t_span=(0.0, 1.0), y0=y0, atol=1e-6, rtol=1e-6, tile_b=2,
            rwa_signal_map=solver._rwa_signal_map,
            mesh=mesh if use_mesh else None,
        )
        return jnp.mean(jnp.abs(yf[:, 1]) ** 2)

    g_mesh = jax.jit(jax.grad(lambda a: loss(a, True)))(amps)
    g_single = jax.grad(lambda a: loss(a, False))(amps)
    np.testing.assert_allclose(np.asarray(g_mesh), np.asarray(g_single), atol=1e-15)
