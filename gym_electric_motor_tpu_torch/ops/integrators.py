"""Fixed-step ODE integrators for the per-control-cycle loop.

The euler and rk4 steps of ``gym_electric_motor_tpu/ops/integrators.py``,
in the same operation order.  Each has the signature ``(f, y, t, dt, *args)
-> y'`` where ``f(t, y, *args)`` returns dy/dt; ``y`` carries a leading env
dimension and ``dt`` is a Python float.
"""

from __future__ import annotations

from typing import Callable


def euler_step(f, y, t, dt, *args):
    return y + dt * f(t, y, *args)


def rk4_step(f, y, t, dt, *args):
    half = 0.5 * dt
    k1 = f(t, y, *args)
    k2 = f(t + half, y + half * k1, *args)
    k3 = f(t + half, y + half * k2, *args)
    k4 = f(t + dt, y + dt * k3, *args)
    return y + (dt / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)


_STEPPERS = {
    "euler": euler_step,
    "rk4": rk4_step,
}


def make_integrator(kind: str = "rk4", substeps: int = 1) -> Callable:
    """Return ``integrate(f, y, t, dt, *args) -> y_next``.

    Only the ``euler`` and ``rk4`` kinds exist in this package so far; the
    others (heun, rk45, rk45_adaptive, implicit_euler) come with the rest of
    the catalog."""
    if kind not in _STEPPERS:
        raise NotImplementedError(
            f"solver {kind!r} is not ported yet (euler and rk4 only); the "
            "other integrators arrive with slice 3 of the port")
    stepper = _STEPPERS[kind]
    if substeps == 1:
        return stepper

    inv = 1.0 / substeps

    def integrate(f, y, t, dt, *args):
        dt_sub = dt * inv
        for i in range(substeps):
            y = stepper(f, y, t + i * dt_sub, dt_sub, *args)
        return y

    return integrate
