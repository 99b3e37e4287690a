"""SCML (Supply-Converter-Motor-Load) physical systems on batched tensors.

Counterpart of ``gym_electric_motor_tpu/physical_systems.py``: a host-side
builder closes over the component specs and provides

* ``reset_from_u(u, n) -> (PhysicsState, system_state)``
* ``simulate(state, action) -> (PhysicsState', system_state)``

for a batch of ``n`` envs (leading dimension of every tensor).
``system_state`` is the normalised full state vector (state / limits).

The DC system (PermExDc, SeriesDc, ShuntDc, ExtExDc with the 1QC, 2QC,
4QC or dual-4QC multi converter) is ``SCMLSystem`` itself; the synchronous
system (PMSM, SynRM) and the squirrel-cage induction system (SCIM), each on
a finite or continuous B6 bridge, the externally excited synchronous
system (EESM, a B6 bridge beside a 4QC for the excitation), the doubly
fed induction system (DFIM, a B6 bridge on the stator and one on the
rotor) and the switched reluctance system (SRM, on an asymmetric bridge)
subclass it, as in the JAX package.  All take an ideal supply and a
constant-speed or polynomial static load; with zero interlocking time the
converter schedule is a single sub-interval per control cycle.
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
from .ops.transforms import (
    TWO_PI,
    abc_to_alphabeta,
    abc_to_dq,
    alphabeta_to_abc,
    alphabeta_to_dq,
    dq_to_abc,
    dq_to_alphabeta,
    wrap_angle,
)


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
class SCMLSystem:
    """Base drive train, the DC one (``DcMotorSystem``, physical_systems.py:
    118-430 of the JAX package, at one converter sub-interval).  ODE state
    ``[mechanical states, motor ODE states]``, omega first: the load's
    mechanical state (constant for ``ConstantSpeedLoad``, integrated with the
    currents for ``PolynomialStaticLoad``).  The system state is ``[mech,
    torque, currents, voltages, u_sup]`` over the limits; the state space is
    polarity-aware (``_motor_state_space``).  A finite action is an ``(N,)``
    integer tensor (``(N, 2)`` for the ExtExDc multi converter), a continuous
    one ``(N, n_dims)``."""

    supply: SupplySpec
    converter: ConverterSpec
    motor: MotorSpec
    load: LoadSpec
    tau: float = 1e-4
    solver: str = "rk4"
    substeps: int = 1
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self._validate()
        self.converter.tau = self.tau
        self.n_mech = len(self.load.state_names)
        self.state_names = self._build_state_names()
        self.state_positions = {n: i for i, n in enumerate(self.state_names)}
        self._set_limits()
        self._build_state_space()
        self.mp = self.motor.mp()
        self.lp = self.load.lp(self.motor.parameter["j_rotor"])
        self.sp = self.supply.sp()
        self.integrate = make_integrator(self.solver, self.substeps)
        self._build_initializers()
        self._limits_host = np.asarray(self.limits, dtype=np.float32)

    # ---------------- host-side construction ----------------

    def _validate(self):
        pass

    def _build_state_names(self):
        return (list(self.load.state_names) + ["torque"] + list(self.motor.currents)
                + list(self.motor.voltages) + self._u_sup_names())

    def _build_state_space(self):
        """Polarity-aware box from the motor and converter topology
        (physical_systems.py:203-214 of the JAX package)."""
        low, high = self._motor_state_space()
        low_arr = np.array([float(low.get(s, -1.0)) for s in self.state_names])
        high_arr = np.array([float(high.get(s, 1.0)) for s in self.state_names])
        sup_lo, sup_hi = self.supply.supply_range
        for j in self._u_sup_indices():
            high_arr[j] = sup_hi / self.supply.u_nominal
            low_arr[j] = sup_lo / self.supply.u_nominal if sup_lo != sup_hi else 0.0
        self.state_space_low = low_arr
        self.state_space_high = high_arr

    def _motor_state_space(self):
        """Each DC motor's ``get_state_space`` (dc_*_motor.py of the
        reference, physical_systems.py:216-253 of the JAX package): omega,
        torque and the currents may not go negative where the converter
        cannot drive them there."""
        cur_lo = self.converter.currents[0]
        volt_lo = self.converter.voltages[0]
        kind = self.motor.kind
        if kind == "PermExDc":
            low = {"omega": -1 if volt_lo[0] == -1 else 0, "torque": -1 if cur_lo[0] == -1 else 0,
                   "i": -1 if cur_lo[0] == -1 else 0, "u": -1 if volt_lo[0] == -1 else 0}
        elif kind == "SeriesDc":
            low = {"omega": 0, "torque": 0, "i": -1 if cur_lo[0] == -1 else 0,
                   "u": -1 if volt_lo[0] == -1 else 0}
        elif kind == "ShuntDc":
            low = {"omega": 0, "torque": -1 if cur_lo[0] == -1 else 0,
                   "i_a": -1 if cur_lo[0] == -1 else 0, "i_e": -1 if cur_lo[0] == -1 else 0,
                   "u": -1 if volt_lo[0] == -1 else 0}
        else:  # ExtExDc (dc_motor.py:129-151)
            low = {"omega": -1 if (volt_lo[0] == -1 or volt_lo[1] == -1) else 0,
                   "torque": -1 if (cur_lo[0] == -1 or cur_lo[1] == -1) else 0,
                   "i_a": -1 if cur_lo[0] == -1 else 0, "i_e": -1 if cur_lo[1] == -1 else 0,
                   "u_a": -1 if volt_lo[0] == -1 else 0, "u_e": -1 if volt_lo[1] == -1 else 0}
        return low, {k: 1 for k in low}

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

    def _motor_init_bounds(self, names):
        return self._init_bounds(names)

    def _build_initializers(self):
        m_names = list(self.motor.initializer.get("states", {}).keys()) or list(self.motor.ode_states)
        m_lo, m_hi = self._motor_init_bounds(m_names)
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

    def _reset_parts(self, u, n, device):
        """The component resets (physical_systems.py:256-287, order motor,
        load, supply): motor and mechanical states, supply voltage and
        state."""
        n_m, n_l = self._motor_n_u, self._load_n_u
        u_m = u[:, :n_m] if n_m else None
        u_l = u[:, n_m:n_m + n_l] if n_l else None
        u_s = u[:, n_m + n_l:] if self.supply.n_reset_u else None
        motor_state = self._sample_motor_u(u_m, n, self.dtype, device)
        mech_state = self._sample_load_u(u_l, n, self.dtype, device)
        u_sup, sup_state = self.supply.reset_u(self.sp, u_s, n, self.dtype, device)
        return motor_state, mech_state, u_sup, sup_state

    def _physics_state(self, ode_state, conv_state, sup_state, n, device):
        return PhysicsState(ode_state=ode_state.contiguous(), conv_state=conv_state,
                            sup_state=sup_state,
                            t=torch.zeros((n,), dtype=self.dtype, device=device),
                            k=torch.zeros((n,), dtype=torch.int32, device=device))

    def reset_from_u(self, u, n: int, device):
        """physical_systems.py:348-373 of the JAX package."""
        motor_state, mech_state, u_sup, sup_state = self._reset_parts(u, n, device)
        u_in = torch.tensor(self.converter.u_reset, dtype=self.dtype, device=device) * u_sup[:, 0:1]
        torque = self.motor.torque(self.mp, motor_state)
        system_state = self._assemble_reset(mech_state, torque, motor_state, u_in, u_sup)
        ps = self._physics_state(torch.cat([mech_state, motor_state], dim=1),
                                 self.converter.init_state(n, device), sup_state, n, device)
        return ps, system_state / self.limits_tensor(device)

    def _assemble_reset(self, mech_state, torque, motor_state, u_in, u_sup):
        """The system state after a reset, before the limits divide it."""
        currents = motor_state[:, : len(self.motor.currents)]
        return torch.cat([mech_state, torque[:, None], currents, u_in, u_sup], dim=1)

    def simulate(self, ps: PhysicsState, action, noise=None):
        """One control period (physical_systems.py:375-427 of the JAX
        package): converter fractions from the pre-step motor current, times
        the supply voltage, one integration over the period."""
        ode = ps.ode_state
        i_in = self.motor.i_in(self.mp, ode[:, self.motor_slice])
        (bridge,) = self.converter.interval_states(ps.conv_state, action)
        i_sup = self.converter.i_sup(ps.conv_state, action, i_in)
        u_sup, sup_state = self.supply.get_voltage(self.sp, ps.sup_state, ps.t, i_sup)
        u_in = self.converter.u_frac(bridge, action, i_in) * u_sup[:, 0:1]
        ode = self.integrate(self._rhs, ode, ps.t, self.tau, u_in, noise)
        torque = self.motor.torque(self.mp, ode[:, self.motor_slice])
        currents = ode[:, self.motor_slice][:, : len(self.motor.currents)]
        system_state = torch.cat([ode[:, : self.n_mech], torque[:, None], currents, u_in, u_sup],
                                 dim=1)
        new_ps = PhysicsState(ode_state=ode, conv_state=bridge, sup_state=sup_state,
                              t=ps.t + self.tau, k=ps.k + 1)
        return new_ps, system_state / self.limits_tensor(ode.device)


class DcMotorSystem(SCMLSystem):
    """PermExDc, SeriesDc, ShuntDc and ExtExDc drive trains
    (physical_systems.py:290-318 of the reference)."""


@dataclasses.dataclass
class SRMSystem(SCMLSystem):
    """Switched reluctance drive train (``SRMSystem`` of the JAX package's
    physical_systems.py:441-529, an extension: the reference stubs the SRM).
    ODE state ``[omega, i_a, i_b, i_c, epsilon]`` with the sinusoidal
    inductance model; the asymmetric bridge applies {0, +u_sup, -u_sup} per
    phase.  After each control period the phase currents clamp at zero
    (ideal freewheel diodes; the clamp is not applied inside the RK4
    stages) and epsilon wraps to [-pi, pi), unlike the [0, 2 pi) of the
    other families.  A finite action is ``(N, 3)``, a continuous one
    ``(N, 3)`` duties."""

    def _build_state_names(self):
        return list(self.load.state_names) + [
            "torque", "i_a", "i_b", "i_c", "u_a", "u_b", "u_c", "epsilon",
        ] + self._u_sup_names()

    def _build_state_space(self):
        low = -np.ones(len(self.state_names))
        high = np.ones(len(self.state_names))
        for name in ("i_a", "i_b", "i_c"):  # unipolar phase currents
            low[self.state_positions[name]] = 0.0
        for j in self._u_sup_indices():
            low[j] = 0.0
        self.state_space_low = low
        self.state_space_high = high

    @property
    def eps_idx(self):
        return self.n_mech + 3

    def _assemble_reset(self, mech_state, torque, motor_state, u_in, u_sup):
        return torch.cat([mech_state, torque[:, None], motor_state[:, :3], u_in,
                          motor_state[:, 3:4], u_sup], dim=1)

    def simulate(self, ps: PhysicsState, action, noise=None):
        """The base period, then the clamp of the phase currents at zero,
        the wrap of epsilon and the torque of the clamped state."""
        ode = ps.ode_state
        i_in = self.motor.i_in(self.mp, ode[:, self.motor_slice])
        i_sup = self.converter.i_sup(ps.conv_state, action, i_in)
        u_sup, sup_state = self.supply.get_voltage(self.sp, ps.sup_state, ps.t, i_sup)
        u_in = self.converter.u_frac(ps.conv_state, action, i_in) * u_sup[:, 0:1]
        ode = self.integrate(self._rhs, ode, ps.t, self.tau, u_in, noise)
        i_clamped = ode[:, self.n_mech:self.n_mech + 3]
        i_clamped = torch.where(i_clamped < 0.0, torch.zeros_like(i_clamped), i_clamped)
        eps = ode[:, self.eps_idx]
        eps = eps - TWO_PI * torch.floor((eps + math.pi) / TWO_PI)
        ode = torch.cat([ode[:, : self.n_mech], i_clamped, eps[:, None]], dim=1)
        torque = self.motor.torque(self.mp, ode[:, self.motor_slice])
        system_state = torch.cat([ode[:, : self.n_mech], torque[:, None], i_clamped, u_in,
                                  eps[:, None], u_sup], dim=1)
        new_ps = PhysicsState(ode_state=ode, conv_state=ps.conv_state, sup_state=sup_state,
                              t=ps.t + self.tau, k=ps.k + 1)
        return new_ps, system_state / self.limits_tensor(ode.device)


@dataclasses.dataclass
class SynchronousMotorSystem(SCMLSystem):
    """PMSM / SynRM drive train (physical_systems.py:418-561 of the
    reference).  ODE state ``[omega, i_sd, i_sq, epsilon]`` in the dq frame,
    omega first.  The converter voltages are Park-transformed with the rotor
    angle from the start of the control cycle; a finite action is an
    ``(N,)`` integer tensor, a continuous one ``(N, 3)``."""

    control_space: str = "abc"

    def _validate(self):
        if self.control_space != "abc":
            raise NotImplementedError(
                "control_space='dq' is not ported yet; it arrives with the "
                "universal wraps of queue 2, item 7 of the port")

    def _build_state_names(self):
        return (list(self.load.state_names) + [
            "torque",
            "i_a", "i_b", "i_c", "i_sd", "i_sq",
            "u_a", "u_b", "u_c", "u_sd", "u_sq",
            "epsilon",
        ] + self._u_sup_names())

    def _build_state_space(self):
        low = -np.ones(len(self.state_names))
        high = np.ones(len(self.state_names))
        for j in self._u_sup_indices():
            low[j] = 0.0
        self.state_space_low = low
        self.state_space_high = high

    @property
    def eps_idx(self):
        """Index of epsilon inside the ode_state vector."""
        return self.n_mech + len(self.motor.currents)

    # ---------------- batched functions ----------------

    def reset_from_u(self, u, n: int, device):
        """physical_systems.py:256-287 (component order: motor, load, supply)."""
        motor_state, mech_state, u_sup, sup_state = self._reset_parts(u, n, device)
        ode_state = torch.cat([mech_state, motor_state], dim=1)
        eps = ode_state[:, self.eps_idx]
        eps = torch.where(eps > math.pi, eps - 2 * math.pi, eps)
        u_abc = torch.tensor(self.converter.u_reset, dtype=self.dtype, device=device) * u_sup[:, 0:1]
        u_dq = abc_to_dq(u_abc, eps)
        i_dq = ode_state[:, self.n_mech: self.n_mech + 2]
        i_abc = dq_to_abc(i_dq, eps)
        torque = self.motor.torque(self.mp, motor_state)
        system_state = torch.cat(
            [mech_state, torque[:, None], i_abc, i_dq, u_abc, u_dq, eps[:, None], u_sup], dim=1)
        ps = self._physics_state(ode_state, self.converter.init_state(n, device), sup_state, n,
                                 device)
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


@dataclasses.dataclass
class EESMSystem(SynchronousMotorSystem):
    """Externally excited synchronous drive train (physical_systems.py:
    648-754 of the JAX package).  ODE state ``[omega, i_sd, i_sq, i_e,
    epsilon]``; the converter is a B6 bridge beside a 4QC for the
    excitation, so its output is the three stator phases and the excitation
    voltage, of which only the stator part is Park-transformed.  A finite
    action is ``(N, 2)`` (B6, 4QC), a continuous one ``(N, 4)``."""

    def _build_state_names(self):
        return (list(self.load.state_names) + [
            "torque",
            "i_a", "i_b", "i_c", "i_sd", "i_sq", "i_e",
            "u_a", "u_b", "u_c", "u_sd", "u_sq", "u_e",
            "epsilon",
        ] + self._u_sup_names())

    def reset_from_u(self, u, n: int, device):
        """physical_systems.py:674-697 of the JAX package."""
        motor_state, mech_state, u_sup, sup_state = self._reset_parts(u, n, device)
        ode_state = torch.cat([mech_state, motor_state], dim=1)
        eps = ode_state[:, self.eps_idx]
        eps = torch.where(eps > math.pi, eps - 2 * math.pi, eps)
        u_out = torch.tensor(self.converter.u_reset, dtype=self.dtype, device=device) * u_sup[:, 0:1]
        u_abc, u_e = u_out[:, :3], u_out[:, 3:]
        u_dq = abc_to_dq(u_abc, eps)
        i_dq_e = motor_state[:, :3]
        i_abc = dq_to_abc(i_dq_e[:, :2], eps)
        torque = self.motor.torque(self.mp, motor_state)
        system_state = torch.cat(
            [mech_state, torque[:, None], i_abc, i_dq_e, u_abc, u_dq, u_e, eps[:, None], u_sup],
            dim=1)
        ps = self._physics_state(ode_state, self.converter.init_state(n, device), sup_state, n,
                                 device)
        return ps, system_state / self.limits_tensor(device)

    def simulate(self, ps: PhysicsState, action, noise=None):
        """One control period (physical_systems.py:699-754 of the JAX
        package): the stator voltages Park-transformed at the cycle-start
        angle, the excitation voltage passed straight through; the abc
        currents take the angle from before the integration."""
        ode = ps.ode_state
        eps = ode[:, self.eps_idx]
        i_dq_e = self.motor.i_in(self.mp, ode[:, self.motor_slice])
        i_in = torch.cat([dq_to_abc(i_dq_e[:, :2], eps), i_dq_e[:, 2:]], dim=1)
        intervals = self.converter.interval_states(ps.conv_state, action)
        cur = ps.conv_state
        sup_state = ps.sup_state
        t = ps.t
        u_in = u_dq_e = u_sup = None
        for j, dur in enumerate(self.converter.interval_durations()):
            i_sup = self.converter.i_sup(cur, action, i_in)
            u_sup, sup_state = self.supply.get_voltage(self.sp, sup_state, ps.t, i_sup)
            u_in = self.converter.u_frac(intervals[j], action, i_in) * u_sup[:, 0:1]
            u_dq_e = torch.cat([abc_to_dq(u_in[:, :3], eps), u_in[:, 3:]], dim=1)
            ode = self.integrate(self._rhs, ode, t, dur, u_dq_e, noise)
            cur = intervals[j]
            t = t + dur
        torque = self.motor.torque(self.mp, ode[:, self.motor_slice])
        i_dq_e = ode[:, self.n_mech: self.n_mech + 3]
        i_abc = dq_to_abc(i_dq_e[:, :2], eps)
        eps_out = wrap_angle(ode[:, self.eps_idx])
        system_state = torch.cat(
            [ode[:, : self.n_mech], torque[:, None], i_abc, i_dq_e, u_in[:, :3], u_dq_e,
             eps_out[:, None], u_sup], dim=1)
        new_ps = PhysicsState(ode_state=ode, conv_state=cur, sup_state=sup_state,
                              t=ps.t + self.tau, k=ps.k + 1)
        return new_ps, system_state / self.limits_tensor(ode.device)


@dataclasses.dataclass
class SCIMSystem(SCMLSystem):
    """Squirrel-cage induction drive train (physical_systems.py:763-940 of
    the JAX package).  ODE state ``[omega, i_salpha, i_sbeta, psi_ralpha,
    psi_rbeta, epsilon]`` in the stator-fixed alpha/beta frame, omega
    first: the converter voltages are Clarke-transformed only.  The field
    angle ``eps_fs = atan2(psi_rbeta, psi_ralpha)`` from the start of the
    control cycle orients the dq outputs; a finite action is an ``(N,)``
    integer tensor, a continuous one ``(N, 3)``."""

    control_space: str = "abc"

    def _validate(self):
        if self.control_space != "abc":
            raise NotImplementedError(
                "control_space='dq' is not ported yet; it arrives with the "
                "universal wraps of queue 2, item 7 of the port")

    def _build_state_names(self):
        return (list(self.load.state_names) + [
            "torque",
            "i_sa", "i_sb", "i_sc", "i_sd", "i_sq",
            "u_sa", "u_sb", "u_sc", "u_sd", "u_sq",
            "epsilon",
        ] + self._u_sup_names())

    def _build_state_space(self):
        low = -np.ones(len(self.state_names))
        high = np.ones(len(self.state_names))
        for j in self._u_sup_indices():
            low[j] = 0.0
        self.state_space_low = low
        self.state_space_high = high

    @property
    def eps_idx(self):
        return self.n_mech + 4

    def _motor_init_bounds(self, names):
        """Symmetric bounds (electric_motor.py:199-213 of the reference):
        the currents' nominal value, the flux's at omega = 0 (``l_m *
        i_sd_nominal``, induction_motor.py:268-269), pi for the angle."""
        nominal = self.motor.nominal
        psi_max = self.motor.parameter["l_m"] * nominal.get("i_sd", nominal.get("i", 1.0))
        per_name = {"i_salpha": nominal.get("i", 1.0), "i_sbeta": nominal.get("i", 1.0),
                    "psi_ralpha": psi_max, "psi_rbeta": psi_max, "epsilon": np.pi}
        upper = np.array([abs(per_name[n]) for n in names])
        return -upper, upper

    def _build_initializers(self):
        super()._build_initializers()
        if not self.motor.initializer.get("random_init"):
            return
        # The random-field-angle flux initialisation
        # (squirrel_cage_induction_motor.py:146-157 of the reference): one
        # more uniform per reset draws eps_mag ~ U(-pi, pi), and the drawn
        # flux magnitude is split into its alpha/beta parts along it.
        base_sample, base_n_u = self._sample_motor_u, self._motor_n_u
        ode_states = list(self.motor.ode_states)
        ia, ib = ode_states.index("psi_ralpha"), ode_states.index("psi_rbeta")

        def sample(u, n, dtype, device):
            vals = base_sample(u[:, :base_n_u], n, dtype, device).clone()
            eps_mag = TWO_PI * u[:, base_n_u] - math.pi
            mag = torch.abs(vals[:, ia])
            vals[:, ia] = mag * torch.cos(eps_mag)
            vals[:, ib] = mag * torch.sin(eps_mag)
            return vals

        self._sample_motor_u = sample
        self._motor_n_u = base_n_u + 1

    def _field_angle(self, ode):
        return torch.atan2(ode[:, self.n_mech + 3], ode[:, self.n_mech + 2])

    def reset_from_u(self, u, n: int, device):
        """physical_systems.py:852-876 of the JAX package (the load resets
        first there; the component samples are independent)."""
        motor_state, mech_state, u_sup, sup_state = self._reset_parts(u, n, device)
        ode_state = torch.cat([mech_state, motor_state], dim=1)
        eps = ode_state[:, self.eps_idx]
        eps = torch.where(eps > math.pi, eps - 2 * math.pi, eps)
        eps_fs = self._field_angle(ode_state)
        u_abc = torch.tensor(self.converter.u_reset, dtype=self.dtype, device=device) * u_sup[:, 0:1]
        u_dq = abc_to_dq(u_abc, eps_fs)
        i_dq = alphabeta_to_dq(ode_state[:, self.n_mech: self.n_mech + 2], eps_fs)
        i_abc = dq_to_abc(i_dq, eps_fs)
        torque = self.motor.torque(self.mp, motor_state)
        system_state = torch.cat(
            [mech_state, torque[:, None], i_abc, i_dq, u_abc, u_dq, eps[:, None], u_sup], dim=1)
        ps = self._physics_state(ode_state, self.converter.init_state(n, device), sup_state, n,
                                 device)
        return ps, system_state / self.limits_tensor(device)

    def simulate(self, ps: PhysicsState, action, noise=None):
        """One control period (physical_systems.py:878-932 of the JAX
        package): Clarke only, no Park.  The dq outputs take the field angle
        from before the integration (physical_systems.py:883, :921-925)."""
        ode = ps.ode_state
        eps_fs = self._field_angle(ode)
        i_in = alphabeta_to_abc(self.motor.i_in(self.mp, ode[:, self.motor_slice]))
        intervals = self.converter.interval_states(ps.conv_state, action)
        cur = ps.conv_state
        sup_state = ps.sup_state
        t = ps.t
        u_in = u_sup = None
        for j, dur in enumerate(self.converter.interval_durations()):
            i_sup = self.converter.i_sup(cur, action, i_in)
            u_sup, sup_state = self.supply.get_voltage(self.sp, sup_state, ps.t, i_sup)
            u_in = self.converter.u_frac(intervals[j], action, i_in) * u_sup[:, 0:1]
            ode = self.integrate(self._rhs, ode, t, dur, abc_to_alphabeta(u_in), noise)
            cur = intervals[j]
            t = t + dur
        u_dq = abc_to_dq(u_in, eps_fs)
        torque = self.motor.torque(self.mp, ode[:, self.motor_slice])
        i_dq = alphabeta_to_dq(ode[:, self.n_mech: self.n_mech + 2], eps_fs)
        i_abc = dq_to_abc(i_dq, eps_fs)
        eps_out = wrap_angle(ode[:, self.eps_idx])
        system_state = torch.cat(
            [ode[:, : self.n_mech], torque[:, None], i_abc, i_dq, u_in, u_dq, eps_out[:, None],
             u_sup], dim=1)
        new_ps = PhysicsState(ode_state=ode, conv_state=cur, sup_state=sup_state,
                              t=ps.t + self.tau, k=ps.k + 1)
        return new_ps, system_state / self.limits_tensor(ode.device)


@dataclasses.dataclass
class DFIMSystem(SCIMSystem):
    """Doubly fed induction drive train (physical_systems.py:943-1073 of the
    JAX package): the SCIM's alpha/beta ODE state ``[omega, i_salpha,
    i_sbeta, psi_ralpha, psi_rbeta, epsilon]`` with a second B6 bridge on
    the rotor windings.  The stator voltages are Clarke-transformed; the
    rotor's "def" voltages go to dq at the field angle less the electrical
    angle, then to alpha/beta at the field angle, both angles from the start
    of the control cycle.  The rotor currents are rebuilt from the fluxes.
    A finite action is ``(N, 2)`` (stator bridge, rotor bridge), a
    continuous one ``(N, 6)``."""

    def _validate(self):
        # the reference's DoublyFedInductionMotorSystem takes no
        # control_space at all (physical_systems.py:850-860 of the reference)
        if self.control_space == "dq":
            raise ValueError("control_space='dq' is not supported for the DFIM (the reference "
                             "rejects it too: physical_systems.py:850-860)")
        super()._validate()

    def _build_state_names(self):
        return (list(self.load.state_names) + [
            "torque",
            "i_sa", "i_sb", "i_sc", "i_sd", "i_sq",
            "i_ra", "i_rb", "i_rc", "i_rd", "i_rq",
            "u_sa", "u_sb", "u_sc", "u_sd", "u_sq",
            "u_ra", "u_rb", "u_rc", "u_rd", "u_rq",
            "epsilon",
        ] + self._u_sup_names())

    def _rotor_current(self, ode):
        """i_r = psi_r / l_r - l_m / l_r i_s in the stator frame
        (physical_systems.py:970-975 of the JAX package)."""
        mp = self.mp
        l_r = mp["l_m"] + mp["l_sigr"]
        i_s = ode[:, self.n_mech: self.n_mech + 2]
        psi_r = ode[:, self.n_mech + 2: self.n_mech + 4]
        return psi_r / l_r - (mp["l_m"] / l_r) * i_s

    def reset_from_u(self, u, n: int, device):
        """physical_systems.py:977-1005 of the JAX package: at reset the
        rotor dq current is taken at the field angle less the electrical
        angle."""
        motor_state, mech_state, u_sup, sup_state = self._reset_parts(u, n, device)
        ode_state = torch.cat([mech_state, motor_state], dim=1)
        eps_el = ode_state[:, self.eps_idx]
        eps_el = torch.where(eps_el > math.pi, eps_el - 2 * math.pi, eps_el)
        eps_field = self._field_angle(ode_state)
        eps_field = torch.where(eps_field > math.pi, eps_field - 2 * math.pi, eps_field)
        u_out = torch.tensor(self.converter.u_reset, dtype=self.dtype, device=device) * u_sup[:, 0:1]
        u_sabc, u_rdef = u_out[:, :3], u_out[:, 3:6]
        u_sdq = abc_to_dq(u_sabc, eps_field)
        u_rdq = abc_to_dq(u_rdef, eps_field - eps_el)
        i_sdq = alphabeta_to_dq(ode_state[:, self.n_mech: self.n_mech + 2], eps_field)
        i_sabc = dq_to_abc(i_sdq, eps_field)
        i_rdq = alphabeta_to_dq(self._rotor_current(ode_state), eps_field - eps_el)
        i_rdef = dq_to_abc(i_rdq, eps_field - eps_el)
        torque = self.motor.torque(self.mp, motor_state)
        system_state = torch.cat(
            [mech_state, torque[:, None], i_sabc, i_sdq, i_rdef, i_rdq, u_sabc, u_sdq, u_rdef,
             u_rdq, eps_el[:, None], u_sup], dim=1)
        ps = self._physics_state(ode_state, self.converter.init_state(n, device), sup_state, n,
                                 device)
        return ps, system_state / self.limits_tensor(device)

    def simulate(self, ps: PhysicsState, action, noise=None):
        """One control period (physical_systems.py:1007-1073 of the JAX
        package).  Two output quirks of the reference are kept: after a step
        the rotor dq current is taken at the field angle (at reset, at the
        field angle less the electrical angle), and the rotor "def" currents
        are the stator-frame rotor currents Clarke-inverted, never rotated
        into the rotor frame."""
        ode = ps.ode_state
        eps_field = self._field_angle(ode)
        eps_el = ode[:, self.eps_idx]
        i_sabc = alphabeta_to_abc(self.motor.i_in(self.mp, ode[:, self.motor_slice]))
        i_rdef = alphabeta_to_abc(self._rotor_current(ode))
        i_in = torch.cat([i_sabc, i_rdef], dim=1)
        intervals = self.converter.interval_states(ps.conv_state, action)
        cur = ps.conv_state
        sup_state = ps.sup_state
        t = ps.t
        u_in = u_sup = None
        for j, dur in enumerate(self.converter.interval_durations()):
            i_sup = self.converter.i_sup(cur, action, i_in)
            u_sup, sup_state = self.supply.get_voltage(self.sp, sup_state, ps.t, i_sup)
            u_in = self.converter.u_frac(intervals[j], action, i_in) * u_sup[:, 0:1]
            u_rdq = abc_to_dq(u_in[:, 3:6], eps_field - eps_el)
            u_sr = (abc_to_alphabeta(u_in[:, :3]), dq_to_alphabeta(u_rdq, eps_field))
            ode = self.integrate(self._rhs, ode, t, dur, u_sr, noise)
            cur = intervals[j]
            t = t + dur
        u_sabc, u_rdef = u_in[:, :3], u_in[:, 3:6]
        u_sdq = abc_to_dq(u_sabc, eps_field)
        torque = self.motor.torque(self.mp, ode[:, self.motor_slice])
        i_sdq = alphabeta_to_dq(ode[:, self.n_mech: self.n_mech + 2], eps_field)
        i_rdq = alphabeta_to_dq(self._rotor_current(ode), eps_field)
        eps_out = wrap_angle(ode[:, self.eps_idx])
        system_state = torch.cat(
            [ode[:, : self.n_mech], torque[:, None], dq_to_abc(i_sdq, eps_field), i_sdq,
             dq_to_abc(i_rdq, eps_field - eps_el), i_rdq, u_sabc, u_sdq, u_rdef, u_rdq,
             eps_out[:, None], u_sup], dim=1)
        new_ps = PhysicsState(ode_state=ode, conv_state=cur, sup_state=sup_state,
                              t=ps.t + self.tau, k=ps.k + 1)
        return new_ps, system_state / self.limits_tensor(ode.device)
