"""Classical control for the switched reluctance family, on batched tensors.

Counterpart of ``gym_electric_motor_tpu/controllers/srm.py`` (an extension
of the JAX package: the reference has no SRM controller).  SRM drives use
position-based commutation: each phase produces torque ``0.5 i^2
dL/dtheta``, so torque of a given sign comes from firing a phase only
while its inductance slope has that sign, with the phase current
regulated by a hysteresis band (finite converter) or a proportional duty
(continuous).

* **CC** -- per-phase current regulation toward the referenced setpoints.
* **TC** -- single-pulse commutation (only the phase with the largest
  usable inductance slope fires) with the sqrt linearization
  ``i* = sqrt(2 |T*| / (p l1 sin_k))``, plus an integral trim on the
  measured torque.
* **SC** -- an anti-windup PI speed loop produces the torque command, then
  the TC logic commutates it.

The law acts on a batch: ``control(cs, obs, ref_obs)`` takes ``(N,
n_state)`` and ``(N, n_ref)`` normalised tensors and the ``(N,)``
integrator ``cs``, in float32 in the JAX law's order, each division by a
tuned constant taken as a product with its float32 reciprocal, as XLA
compiles it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.device import resolve_device
from . import readers
from .controller import _host, _recip, run_closed_loop

_f32 = np.float32


@dataclasses.dataclass
class SRMCommutationController:
    """Host-tuned commutation controller; batched tensor control law."""

    env_id: str
    control_task: str
    action_type: str
    tau: float
    current_idx: np.ndarray
    omega_idx: int
    torque_idx: int
    eps_idx: int
    i_lim: float
    t_lim: float
    w_lim: float
    u_lim: float
    p: float
    l1: float
    r_s: float
    # firing window + regulation
    theta_on: float = 0.2        # min |sin(eps - phi_k)| to fire a phase
    hysteresis: float = 0.02     # finite: band around i* (normalized)
    kp_i: float = 8.0            # cont: duty P gain on the current error
    current_margin: float = 0.2  # setpoint ceiling (1 - margin) * i_lim
    # speed loop (SC)
    kp_w: float = 0.0
    ki_w: float = 0.0
    t_max: float = 0.0
    # TC integral trim on the measured torque (the open-loop sqrt
    # linearization undershoots ~10% from phase-current ramp time)
    ki_t: float = 400.0

    @classmethod
    def make(cls, env, env_id, current_safety_margin=0.2, a=4):
        action_type, control_task, motor_type = readers.split_env_id(env_id)
        assert motor_type == "SRM"
        names = list(env.state_names)
        lim = np.asarray(env.physical_system.limits)
        mp = env.physical_system.motor.parameter
        tau = float(env.physical_system.tau)
        j_total = float(mp["j_rotor"]) + float(getattr(env.physical_system.load, "j_load", 0.0))
        t_lim = float(lim[names.index("torque")])
        # speed PI by the symmetric optimum on the mechanical integrator:
        # bandwidth well under the commutation frequency
        a, tau_w = float(a), 50.0 * tau
        kp_w = j_total / (a * tau_w)
        ki_w = kp_w / (a**2 * tau_w)
        return cls(
            env_id=env_id, control_task=control_task, action_type=action_type, tau=tau,
            current_idx=np.array([names.index(n) for n in ("i_a", "i_b", "i_c")]),
            omega_idx=names.index("omega"), torque_idx=names.index("torque"),
            eps_idx=names.index("epsilon"),
            i_lim=float(lim[names.index("i_a")]), t_lim=t_lim,
            w_lim=float(lim[names.index("omega")]), u_lim=float(lim[names.index("u_a")]),
            p=float(mp["p"]), l1=float(mp["l1"]), r_s=float(mp["r_s"]),
            current_margin=current_safety_margin, kp_w=kp_w, ki_w=ki_w, t_max=0.9 * t_lim,
        )

    @classmethod
    def from_numpy(cls, fields: dict):
        """The port's controller from the JAX controller's fields
        (``vars(jax_ctrl)``); unknown keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _host(v) for k, v in fields.items() if k in names})

    @staticmethod
    def state_from_numpy(cs, device):
        """The ``(N,)`` integrator from the JAX one (a numpy array)."""
        return torch.tensor(np.asarray(cs, dtype=np.float32), device=device)

    # ---- batched control law ----

    def reset(self, n_envs: int = 1, device=None):
        """The speed-PI (SC) or torque-trim (TC) integrator of ``n_envs``
        envs, on ``device`` (``cuda`` unless named, as every entry point)."""
        return torch.zeros((n_envs,), dtype=torch.float32,
                           device=resolve_device(device))

    def _firing(self, eps, sign):
        """Per-phase inductance slope sin(eps - phi_k), ``(N, 3)``, and the
        firing mask for torque of the given sign."""
        phis = torch.tensor([0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0],
                            dtype=torch.float32, device=eps.device)
        s = torch.sin(eps[:, None] - phis)
        fire = (s * sign[:, None]) > self.theta_on
        return s, fire

    def _current_setpoints(self, obs, t_ref):
        """TC/SC: the torque linearization i*_k = sqrt(2|T*| / (p l1 s_k))
        on the single firing phase, normalized."""
        eps = obs[:, self.eps_idx] * math.pi
        sign = torch.sign(t_ref)
        s, fire = self._firing(eps, sign)
        # single-pulse commutation: only the phase with the largest usable
        # inductance slope
        gain = s * sign[:, None]
        best = gain >= gain.max(dim=1, keepdim=True).values
        fire = fire & best
        i_cmd = torch.sqrt(2.0 * torch.abs(t_ref)[:, None]
                           / (self.p * self.l1 * torch.clamp(torch.abs(s), min=0.05)))
        i_max = (1.0 - self.current_margin) * self.i_lim
        i_star = torch.where(fire, torch.clamp(i_cmd, max=i_max), torch.zeros_like(i_cmd))
        return i_star * float(_recip(self.i_lim))

    def _regulate(self, obs, i_star_n):
        """Normalized per-phase setpoints -> the converter action: ``(N,
        3)`` int32 commands (finite: 1 magnetise, 2 demagnetise, 0
        freewheel) or float32 duties."""
        i_n = obs[:, torch.as_tensor(self.current_idx, device=obs.device)]
        if self.action_type == "Finite":
            mag = i_n < i_star_n - self.hysteresis
            dem = i_n > i_star_n + self.hysteresis
            # inside the band: freewheel if a setpoint exists, demagnetize a
            # phase commanded to zero (drive it out fast)
            one, two, zero = (torch.full_like(i_n, v, dtype=torch.int32) for v in (1, 2, 0))
            hold = torch.where(i_star_n > 1e-6, zero, two)
            return torch.where(mag, one, torch.where(dem, two, hold))
        # cont: P on the error + resistive feed-forward duty
        duty_ff = self.r_s * (i_star_n * self.i_lim) * float(_recip(self.u_lim))
        duty = self.kp_i * (i_star_n - i_n) + duty_ff
        return torch.clamp(duty, -1.0, 1.0)

    def control(self, cs, obs, ref_obs, collect_internals=False):
        if self.control_task == "CC":
            action = self._regulate(obs, ref_obs)
            if collect_internals:
                return cs, action, {"i_star": ref_obs * self.i_lim}
            return cs, action
        if self.control_task == "TC":
            t_star = ref_obs[:, 0] * self.t_lim
            t_meas = obs[:, self.torque_idx] * self.t_lim
            integ = torch.clamp(cs + self.ki_t * (t_star - t_meas) * self.tau,
                                -0.3 * self.t_lim, 0.3 * self.t_lim)
            t_ref = t_star + integ
        else:  # SC: anti-windup PI speed loop -> torque command
            w_err = (ref_obs[:, 0] - obs[:, self.omega_idx]) * self.w_lim
            t_raw = self.kp_w * w_err + cs
            t_ref = torch.clamp(t_raw, -self.t_max, self.t_max)
            # integrate only while unsaturated (conditional anti-windup)
            integ = cs + torch.where(t_raw == t_ref, self.ki_w * w_err * self.tau,
                                     torch.zeros_like(w_err))
        i_star_n = self._current_setpoints(obs, t_ref)
        action = self._regulate(obs, i_star_n)
        if collect_internals:
            return integ, action, {"torque_star": t_ref, "i_star": i_star_n * self.i_lim}
        return integ, action

    def control_environment(self, env, n_steps, seed=0, n_envs=None, collect_internals=False):
        """The closed loop of ``GemController.control_environment``."""
        return run_closed_loop(self, env, n_steps, seed, n_envs, collect_internals)
