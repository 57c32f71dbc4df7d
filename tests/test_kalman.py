"""Kalman bank parity vs the NumPy oracle (SURVEY.md §4.1)."""

import numpy as np
import jax.numpy as jnp

from jaxmot.config import KalmanConfig
from jaxmot.ops import kalman

import oracles


def test_predict_correct_parity():
    cfg = KalmanConfig()
    rng = np.random.default_rng(0)
    boxes = np.abs(rng.normal(100, 30, (5, 4))).astype(np.float32) + 10
    mean, cov = kalman.init(jnp.asarray(boxes), cfg)
    oracle_filters = [oracles.KalmanOracle(b) for b in boxes]

    for step in range(6):
        mean, cov = kalman.predict(mean, cov, cfg)
        want_pred = np.stack([f.predict() for f in oracle_filters])
        np.testing.assert_allclose(np.asarray(mean)[:, :4], want_pred,
                                   rtol=1e-4, atol=1e-3)

        z = boxes + rng.normal(0, 2, boxes.shape).astype(np.float32)
        gate = np.ones((5,), bool)
        gate[step % 5] = False          # one coasting track per step
        mean, cov = kalman.correct(mean, cov, jnp.asarray(z),
                                   jnp.asarray(gate), cfg)
        for t in range(5):
            if gate[t]:
                want = oracle_filters[t].correct(z[t])
                np.testing.assert_allclose(np.asarray(mean)[t, :4], want,
                                           rtol=1e-4, atol=1e-3)
        # Oracle covariance parity for the corrected tracks.
        for t in range(5):
            if gate[t]:
                np.testing.assert_allclose(np.asarray(cov)[t],
                                           oracle_filters[t].P,
                                           rtol=1e-3, atol=1e-2)


def test_gated_correct_is_noop():
    cfg = KalmanConfig()
    boxes = jnp.asarray([[50.0, 60.0, 20.0, 30.0]])
    mean, cov = kalman.init(boxes, cfg)
    mean, cov = kalman.predict(mean, cov, cfg)
    z = jnp.asarray([[500.0, 600.0, 10.0, 10.0]])
    m2, c2 = kalman.correct(mean, cov, z, jnp.asarray([False]), cfg)
    np.testing.assert_array_equal(np.asarray(m2), np.asarray(mean))
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(cov))


def test_constant_velocity_convergence():
    """Feeding a linearly moving box must converge to its velocity."""
    cfg = KalmanConfig()
    mean, cov = kalman.init(jnp.asarray([[10.0, 20.0, 16.0, 16.0]]), cfg)
    for k in range(1, 25):
        mean, cov = kalman.predict(mean, cov, cfg)
        z = jnp.asarray([[10.0 + 3.0 * k, 20.0 - 1.5 * k, 16.0, 16.0]])
        mean, cov = kalman.correct(mean, cov, z, jnp.asarray([True]), cfg)
    vel = np.asarray(mean)[0, 4:6]
    np.testing.assert_allclose(vel, [3.0, -1.5], atol=0.1)
