"""SCML (Supply-Converter-Motor-Load) physical systems on batched tensors.

Counterpart of ``gym_electric_motor_tpu/physical_systems.py``: a host-side
builder closes over the component specs and provides

* ``reset_from_u(u, n) -> (PhysicsState, system_state)``
* ``simulate(state, action) -> (PhysicsState', system_state)``

for a batch of ``n`` envs (leading dimension of every tensor).
``system_state`` is the normalised full state vector (state / limits).

Only the synchronous system (PMSM, SynRM) exists so far, with a finite or
continuous B6 bridge, an ideal supply and a constant-speed or polynomial
static load; with zero interlocking time the converter schedule is a single
sub-interval per control cycle.  The other families come with the later
steps of queue 1, slice 3 of the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .models.converters import ConverterSpec
from .models.loads import LoadSpec
from .models.motors import MotorSpec
from .models.supplies import SupplySpec
from .ops.integrators import make_integrator
from .ops.transforms import abc_to_dq, dq_to_abc, wrap_angle


@dataclasses.dataclass
class PhysicsState:
    """Per-env physical state carried across steps (leading env dim)."""

    ode_state: torch.Tensor  # (N, n_ode) [mechanical states, motor ODE states]
    conv_state: torch.Tensor  # (N, n_state) int32 half-bridge switching states
    sup_state: torch.Tensor  # (N, n_sup) supply-internal state
    t: torch.Tensor  # (N,) simulation time
    k: torch.Tensor  # (N,) int32 step counter


def _sample_initializer(initializer, state_names, bounds_low, bounds_high):
    """``(names, n_u, sample(u, n) -> (n, len(names)))`` from an
    initializer spec: constant values or uniform in [low, high]
    (electric_motor.py:179-268 of the reference).  Truncated-normal
    initializers come with slice 3 of the port."""
    states = initializer.get("states") or {state: 0.0 for state in state_names}
    names = list(states.keys())
    const_values = np.array([float(states[n]) for n in names])
    lower = np.asarray(bounds_low, dtype=np.float64)
    upper = np.asarray(bounds_high, dtype=np.float64)
    interval = initializer.get("interval")
    if interval is not None:
        iv = np.asarray(interval, dtype=np.float64)
        lower = np.clip(lower, iv.T[0], None)
        upper = np.clip(upper, None, iv.T[1])
    random_dist = initializer.get("random_init")

    if random_dist is None:
        def sample(u, n, dtype, device):
            vals = torch.tensor(const_values, dtype=torch.float32, device=device)
            return vals.to(dtype).expand(n, len(names))

        return names, 0, sample
    if random_dist == "uniform":
        width = (upper - lower).astype(np.float32)
        low = lower.astype(np.float32)

        def sample(u, n, dtype, device):
            w = torch.tensor(width, device=device)
            lo = torch.tensor(low, device=device)
            return (w * u + lo).to(dtype)

        return names, len(names), sample
    raise NotImplementedError(
        f"random_init={random_dist!r} is not ported yet (constant and uniform "
        "initializers only); it arrives with slice 3 of the port")


@dataclasses.dataclass
class SynchronousMotorSystem:
    """PMSM / SynRM drive train (physical_systems.py:418-561 of the
    reference).  ODE state ``[omega, i_sd, i_sq, epsilon]`` in the dq frame,
    omega first: the load's mechanical state (constant for
    ``ConstantSpeedLoad``, integrated with the currents for
    ``PolynomialStaticLoad``).  The converter voltages are Park-transformed
    with the rotor angle from the start of the control cycle; a finite
    action is an ``(N,)`` integer tensor, a continuous one ``(N, 3)``."""

    supply: SupplySpec
    converter: ConverterSpec
    motor: MotorSpec
    load: LoadSpec
    tau: float = 1e-4
    solver: str = "rk4"
    substeps: int = 1
    dtype: torch.dtype = torch.float32
    control_space: str = "abc"

    def __post_init__(self):
        if self.control_space != "abc":
            raise NotImplementedError(
                "control_space='dq' is not ported yet; it arrives with the "
                "universal wraps of queue 2, item 7 of the port")
        self.converter.tau = self.tau
        self.n_mech = len(self.load.state_names)
        self.state_names = (list(self.load.state_names) + [
            "torque",
            "i_a", "i_b", "i_c", "i_sd", "i_sq",
            "u_a", "u_b", "u_c", "u_sd", "u_sq",
            "epsilon",
        ] + self._u_sup_names())
        self.state_positions = {n: i for i, n in enumerate(self.state_names)}
        self._set_limits()
        low = -np.ones(len(self.state_names))
        high = np.ones(len(self.state_names))
        for j in self._u_sup_indices():
            low[j] = 0.0
        self.state_space_low = low
        self.state_space_high = high
        self.mp = self.motor.mp()
        self.lp = self.load.lp(self.motor.parameter["j_rotor"])
        self.sp = self.supply.sp()
        self.integrate = make_integrator(self.solver, self.substeps)
        self._build_initializers()
        self._limits_host = np.asarray(self.limits, dtype=np.float32)

    # ---------------- host-side construction ----------------

    def _set_limits(self):
        """physical_systems.py:105-123 of the reference."""
        limits = np.zeros(len(self.state_names))
        nominal = np.zeros(len(self.state_names))
        for i, s in enumerate(self.state_names):
            limits[i] = min(self.motor.limits.get(s, np.inf), self.load.limits.get(s, np.inf))
            nominal[i] = min(self.motor.nominal.get(s, np.inf), self.load.nominal.get(s, np.inf))
        for j in self._u_sup_indices():
            limits[j] = self.supply.u_nominal
            nominal[j] = self.supply.u_nominal
        self.limits = limits
        self.nominal_state = nominal

    def _u_sup_names(self):
        if self.supply.voltage_len == 1:
            return ["u_sup"]
        return [f"u_sup_{ph}" for ph in "abc"[: self.supply.voltage_len]]

    def _u_sup_indices(self):
        base = self.state_positions[self._u_sup_names()[0]]
        return range(base, base + self.supply.voltage_len)

    def _init_bounds(self, names):
        """Initialisation bounds: upper = nominal, lower = upper * space_low."""
        idx = [self.state_positions[n] for n in names]
        upper = np.abs(np.array([self.nominal_state[i] for i in idx]))
        lower = upper * np.array([self.state_space_low[i] for i in idx])
        return lower, upper

    def _build_initializers(self):
        m_names = list(self.motor.initializer.get("states", {}).keys()) or list(self.motor.ode_states)
        m_lo, m_hi = self._init_bounds(m_names)
        _, self._motor_n_u, sample_motor = _sample_initializer(
            self.motor.initializer, m_names, m_lo, m_hi)
        # place the sampled values into the motor-ODE layout by name
        perm = [m_names.index(n) if n in m_names else len(m_names)
                for n in self.motor.ode_states]

        def sample_motor_ode(u, n, dtype, device):
            vals = sample_motor(u, n, dtype, device)
            padded = torch.cat([vals, torch.zeros((n, 1), dtype=dtype, device=device)], dim=1)
            return padded[:, perm]

        self._sample_motor_u = sample_motor_ode
        l_names = list(self.load.initializer.get("states", {}).keys()) or list(self.load.state_names)
        l_lo, l_hi = self._init_bounds(l_names)
        _, self._load_n_u, self._sample_load_u = _sample_initializer(
            self.load.initializer, l_names, l_lo, l_hi)

    @property
    def reset_n_u(self):
        """Uniforms one reset consumes (0 for constant initializers)."""
        return self._motor_n_u + self._load_n_u + self.supply.n_reset_u

    @property
    def action_space(self):
        return self.converter.action_space

    @property
    def motor_slice(self):
        return slice(self.n_mech, None)

    @property
    def eps_idx(self):
        """Index of epsilon inside the ode_state vector."""
        return self.n_mech + len(self.motor.currents)

    def limits_tensor(self, device):
        return torch.as_tensor(self._limits_host, device=device).to(self.dtype)

    # ---------------- batched functions ----------------

    def _rhs(self, t, y, u_in, noise):
        """Concatenated load + motor ODE (physical_systems.py:205-236)."""
        motor_state = y[:, self.motor_slice]
        torque = self.motor.torque(self.mp, motor_state)
        d_mech = self.load.ode(self.lp, t, y[:, : self.n_mech], torque, noise)
        d_motor = self.motor.ode(self.mp, motor_state, u_in, y[:, 0])
        return torch.cat([d_mech, d_motor], dim=1)

    def reset_from_u(self, u, n: int, device):
        """physical_systems.py:256-287 (component order: motor, load, supply)."""
        n_m, n_l = self._motor_n_u, self._load_n_u
        u_m = u[:, :n_m] if n_m else None
        u_l = u[:, n_m:n_m + n_l] if n_l else None
        u_s = u[:, n_m + n_l:] if self.supply.n_reset_u else None
        dtype = self.dtype
        motor_state = self._sample_motor_u(u_m, n, dtype, device)
        mech_state = self._sample_load_u(u_l, n, dtype, device)
        ode_state = torch.cat([mech_state, motor_state], dim=1)
        u_sup, sup_state = self.supply.reset_u(self.sp, u_s, n, dtype, device)
        eps = ode_state[:, self.eps_idx]
        eps = torch.where(eps > math.pi, eps - 2 * math.pi, eps)
        conv_state = self.converter.init_state(n, device)
        u_abc = torch.tensor(self.converter.u_reset, dtype=dtype, device=device) * u_sup[:, 0:1]
        u_dq = abc_to_dq(u_abc, eps)
        i_dq = ode_state[:, self.n_mech: self.n_mech + 2]
        i_abc = dq_to_abc(i_dq, eps)
        torque = self.motor.torque(self.mp, motor_state)
        system_state = torch.cat(
            [mech_state, torque[:, None], i_abc, i_dq, u_abc, u_dq, eps[:, None], u_sup], dim=1)
        ps = PhysicsState(
            ode_state=ode_state.contiguous(),
            conv_state=conv_state,
            sup_state=sup_state,
            t=torch.zeros((n,), dtype=dtype, device=device),
            k=torch.zeros((n,), dtype=torch.int32, device=device),
        )
        return ps, system_state / self.limits_tensor(device)

    def simulate(self, ps: PhysicsState, action, noise=None):
        """One control period (physical_systems.py:487-525 of the reference)."""
        ode = ps.ode_state
        eps = ode[:, self.eps_idx]
        i_in = dq_to_abc(self.motor.i_in(self.mp, ode[:, self.motor_slice]), eps)
        intervals = self.converter.interval_states(ps.conv_state, action)
        cur = ps.conv_state
        sup_state = ps.sup_state
        t = ps.t
        u_in = u_dq = u_sup = None
        for j, dur in enumerate(self.converter.interval_durations()):
            i_sup = self.converter.i_sup(cur, action, i_in)
            u_sup, sup_state = self.supply.get_voltage(self.sp, sup_state, ps.t, i_sup)
            u_in = self.converter.u_frac(intervals[j], action, i_in) * u_sup[:, 0:1]
            u_dq = abc_to_dq(u_in, eps)
            ode = self.integrate(self._rhs, ode, t, dur, u_dq, noise)
            cur = intervals[j]
            t = t + dur
        torque = self.motor.torque(self.mp, ode[:, self.motor_slice])
        mech = ode[:, : self.n_mech]
        i_dq = ode[:, self.n_mech: self.n_mech + 2]
        # the reference converts i_dq with the epsilon from *before* the
        # final integration (physical_systems.py:516-521)
        i_abc = dq_to_abc(i_dq, eps)
        eps_out = wrap_angle(ode[:, self.eps_idx])
        system_state = torch.cat(
            [mech, torque[:, None], i_abc, i_dq, u_in, u_dq, eps_out[:, None], u_sup], dim=1)
        new_ps = PhysicsState(ode_state=ode, conv_state=cur, sup_state=sup_state,
                              t=ps.t + self.tau, k=ps.k + 1)
        return new_ps, system_state / self.limits_tensor(ode.device)
