from .integrators import euler_step, make_integrator, rk4_step
from .transforms import (
    T23,
    T32,
    abc_to_alphabeta,
    abc_to_dq,
    alphabeta_to_abc,
    alphabeta_to_dq,
    dq_to_abc,
    dq_to_alphabeta,
    rotate,
    wrap_angle,
)

__all__ = [
    "T23",
    "T32",
    "abc_to_alphabeta",
    "abc_to_dq",
    "alphabeta_to_abc",
    "alphabeta_to_dq",
    "dq_to_abc",
    "dq_to_alphabeta",
    "euler_step",
    "make_integrator",
    "rk4_step",
    "rotate",
    "wrap_angle",
]
