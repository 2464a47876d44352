"""State estimation: state-space models, Kalman filter, extended Kalman
filter, steady-state gain, example models.

Parity: core/src/kalman/kalman.cc:35-654, core/include/tsd/apps/kalman.hpp.

Filtering runs as a `lax.scan` over observations; EKF Jacobians
come from `jax.jacfwd` (exact autodiff — an improvement over the
reference's numeric differencing, kalman.hpp:26-160).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import real_dtype

__all__ = [
    "LinearSSM", "kalman_filter", "ekf_filter", "kalman_steady_gain",
    "ssm_random_walk", "ssm_constant", "kitagawa_model",
]


@dataclasses.dataclass(frozen=True)
class LinearSSM:
    """x' = A x + w, y = C x + v (parity: SSMLineaire, kalman.cc:35-271)."""
    A: np.ndarray
    C: np.ndarray
    Q: np.ndarray       # process noise covariance
    R: np.ndarray       # measurement noise covariance

    @property
    def nx(self) -> int:
        return self.A.shape[0]

    @property
    def ny(self) -> int:
        return self.C.shape[0]

    def simulate(self, key, n: int, x0=None):
        """Draw a trajectory + observations."""
        A = jnp.asarray(self.A, real_dtype)
        C = jnp.asarray(self.C, real_dtype)
        Lq = jnp.asarray(np.linalg.cholesky(
            self.Q + 1e-12 * np.eye(self.nx)), real_dtype)
        Lr = jnp.asarray(np.linalg.cholesky(
            self.R + 1e-12 * np.eye(self.ny)), real_dtype)
        x0 = jnp.zeros(self.nx, real_dtype) if x0 is None else x0
        kw, kv = jax.random.split(key)
        ws = jax.random.normal(kw, (n, self.nx), real_dtype) @ Lq.T
        vs = jax.random.normal(kv, (n, self.ny), real_dtype) @ Lr.T

        def body(x, wv):
            w, v = wv
            x = A @ x + w
            y = C @ x + v
            return x, (x, y)

        _, (xs, ys) = jax.lax.scan(body, x0, (ws, vs))
        return xs, ys


def kalman_filter(ssm: LinearSSM, ys: jax.Array, x0=None, P0=None):
    """Linear Kalman filter over observations ys (n, ny).
    Returns (xs_filtered, Ps) (parity: FiltreKalman, kalman.cc:456-570)."""
    A = jnp.asarray(ssm.A, real_dtype)
    C = jnp.asarray(ssm.C, real_dtype)
    Q = jnp.asarray(ssm.Q, real_dtype)
    R = jnp.asarray(ssm.R, real_dtype)
    nx = ssm.nx
    x0 = jnp.zeros(nx, real_dtype) if x0 is None else jnp.asarray(x0, real_dtype)
    # reference default: identity (kalman.cc:470-473)
    P0 = jnp.eye(nx, dtype=real_dtype) if P0 is None else \
        jnp.asarray(P0, real_dtype)

    def body(carry, y):
        x, P = carry
        # predict
        xp = A @ x
        Pp = A @ P @ A.T + Q
        # update
        S = C @ Pp @ C.T + R
        K = jnp.linalg.solve(S.T, (Pp @ C.T).T).T
        innov = y - C @ xp
        xn = xp + K @ innov
        Pn = (jnp.eye(nx, dtype=real_dtype) - K @ C) @ Pp
        return (xn, Pn), (xn, Pn)

    _, (xs, Ps) = jax.lax.scan(body, (x0, P0), ys)
    return xs, Ps


def ekf_filter(f: Callable, g: Callable, Q, R, ys: jax.Array,
               x0, P0=None):
    """Extended Kalman filter with autodiff Jacobians.

    f(x) -> next state; g(x) -> observation (parity: FiltreEKF,
    kalman.cc:272-455; Jacobians via jax.jacfwd instead of numeric
    differences).
    """
    Q = jnp.asarray(Q, real_dtype)
    R = jnp.asarray(R, real_dtype)
    x0 = jnp.asarray(x0, real_dtype)
    nx = x0.shape[0]
    # reference default: identity (kalman.cc:470-473)
    P0 = jnp.eye(nx, dtype=real_dtype) if P0 is None else \
        jnp.asarray(P0, real_dtype)
    Jf = jax.jacfwd(f)
    Jg = jax.jacfwd(g)

    def body(carry, y):
        x, P = carry
        F = Jf(x)
        xp = f(x)
        Pp = F @ P @ F.T + Q
        G = Jg(xp)
        yp = g(xp)
        S = G @ Pp @ G.T + R
        K = jnp.linalg.solve(S.T, (Pp @ G.T).T).T
        xn = xp + K @ (jnp.atleast_1d(y - yp))
        Pn = (jnp.eye(nx, dtype=real_dtype) - K @ G) @ Pp
        return (xn, Pn), (xn, Pn)

    _, (xs, Ps) = jax.lax.scan(body, (x0, P0), ys)
    return xs, Ps


def kalman_steady_gain(ssm: LinearSSM, iters: int = 200) -> np.ndarray:
    """Steady-state Kalman gain by Riccati iteration (parity: kalman_ssg,
    kalman.hpp:412)."""
    if iters < 1:
        raise ValueError(f"kalman_steady_gain needs iters >= 1 "
                         f"(got {iters})")
    A, C, Q, R = (np.asarray(m, np.float64)
                  for m in (ssm.A, ssm.C, ssm.Q, ssm.R))
    nx = A.shape[0]
    P = np.eye(nx)
    for _ in range(iters):
        Pp = A @ P @ A.T + Q
        S = C @ Pp @ C.T + R
        K = Pp @ C.T @ np.linalg.inv(S)
        P = (np.eye(nx) - K @ C) @ Pp
    return K


# ------------------------------------------------------------ examples

def ssm_random_walk(q: float = 0.01, r: float = 1.0) -> LinearSSM:
    """Scalar random walk observed in noise (parity: modèle marche
    aléatoire, kalman.cc:571-600)."""
    return LinearSSM(A=np.array([[1.0]]), C=np.array([[1.0]]),
                     Q=np.array([[q]]), R=np.array([[r]]))


def ssm_constant(r: float = 1.0) -> LinearSSM:
    """Constant-state model (parity: modèle constante, kalman.cc)."""
    return LinearSSM(A=np.array([[1.0]]), C=np.array([[1.0]]),
                     Q=np.array([[0.0]]), R=np.array([[r]]))


def kitagawa_model():
    """Kitagawa's nonlinear benchmark (parity: kalman.cc:620-654):
    x' = x/2 + 25 x/(1+x^2) + 8 cos(1.2 n); y = x^2/20.
    Returns (f, g) closures taking (x, n) packed as a 2-vector [x, n]."""

    def f(s):
        x, n = s[0], s[1]
        xn = 0.5 * x + 25 * x / (1 + x * x) + 8 * jnp.cos(1.2 * n)
        return jnp.stack([xn, n + 1])

    def g(s):
        return jnp.atleast_1d(s[0] ** 2 / 20.0)

    return f, g
