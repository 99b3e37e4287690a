"""The auto-tuned cascade controller on batched tensors.

Counterpart of ``gym_electric_motor_tpu/controllers/controller.py``:
``GemController.make(env, env_id)`` reproduces the reference's cascade
construction and symmetric-optimum tuning
(``gem_controllers/gem_controller.py:29-99`` upstream):

    InputStage (denormalize)
    -> [SC: PI speed controller -> torque clip -> anti-windup]
    -> [TC: operation-point selection (torque -> currents) -> current clip]
    -> CC: PI current controller + EMF feedforward -> voltage clip
           -> [AC: dq -> abc with advance angle]
    -> OutputStage (normalize / discretize)

The tuning runs on the host in numpy float64, as the JAX package's does.
``control(cs, state, reference)`` acts on a batch: ``state`` is ``(N,
n_state)``, ``reference`` ``(N, n_ref)`` (both normalised, on the env's
device) and the controller state ``cs`` a dict of ``(N, ...)`` float32
tensors (the PI integrators), where the JAX package vmaps a per-env
function.  Its arithmetic follows the JAX law in float32 in the same order,
with each division by a tuned constant taken as a product with the
constant's float32 reciprocal, as XLA compiles it.

Faithfulness notes (kept from the JAX package):

* The clipped voltage is used only for anti-windup; the *unclipped*
  voltage goes through the abc transformation to the output stage, as in
  ``pi_current_controller.py:146-177`` upstream.
* The abc advance angle uses the mechanical omega without the pole-pair
  factor (``abc_transformation.py:55-57`` upstream).
* ``DiscOutputStage.to_b6_discrete`` raises upstream; here, as in the JAX
  package, it is per-phase sigma-delta two-level switching mapped onto the
  Discrete(8) B6 action table (an extension).

What the port serves: the 24 DC ids, the four synchronous current-control
ids ``{Finite, Cont}-CC-{PMSM, SynRM}-v0`` and (through
:class:`~.srm.SRMCommutationController`) the six SRM ids.  The SCIM and
DFIM ids raise the JAX package's ``ValueError`` (they need the flux
observer wrapper, which the port does not have yet); the synchronous
torque and speed tasks and the EESM raise ``NotImplementedError`` naming
the module still to port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.transforms import dq_to_abc
from ..utils import rng
from ..utils.device import resolve_device
from . import readers

_f32 = np.float32


def _detect_env_id(env):
    """Reconstruct the ``{Finite|Cont}-{CC|TC|SC}-{Motor}-v0`` id from env
    properties (the classic stack's auto-detection): the action space's
    class name, the referenced states and the motor kind."""
    action = "Cont" if env.action_space.__class__.__name__ == "Box" else "Finite"
    refs = set(env.reference_names)
    if "omega" in refs:
        task = "SC"
    elif "torque" in refs:
        task = "TC"
    else:
        task = "CC"
    motor = env.physical_system.motor.kind
    return f"{action}-{task}-{motor}-v0"


def _state_arrays(env):
    ps = env.physical_system
    return (
        list(ps.state_names),
        np.asarray(ps.limits, dtype=np.float64),
        np.asarray(ps.state_space_low, dtype=np.float64),
        np.asarray(ps.state_space_high, dtype=np.float64),
    )


def _unported(motor_type, control_task):
    """The ``NotImplementedError`` of an id whose operating-point selection
    (or EMF feedforward) the port does not have yet, or None."""
    if motor_type == "EESM":
        return ("the EESM cascade needs controllers/induction_eesm_ops.py (its operating-point "
                "table and EMF feedforward), which the port does not have yet (ROADMAP.md, "
                "queue 1, slice 5)")
    if motor_type in ("PMSM", "SynRM") and control_task != "CC":
        return (f"{control_task} control of the {motor_type} needs controllers/pmsm_ops.py (the "
                "MTPC/MTPF tables and _quartic_roots), which the port does not have yet "
                "(ROADMAP.md, queue 1, slice 5)")
    return None


def _recip(x):
    """``float32(1) / float32(x)``, elementwise: what XLA multiplies by in
    place of a division by the constant ``x``."""
    return _f32(1.0) / np.asarray(x, dtype=_f32)


def _host(value):
    """A JAX controller field as host data: arrays as numpy, tuples and
    dicts entry by entry."""
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_host(v) for v in value)
    if hasattr(value, "__array__") and not isinstance(value, (np.ndarray, np.generic)):
        return np.asarray(value)
    return value


@dataclasses.dataclass
class GemController:
    """Host-side tuned cascade; batched tensor functions for the control law."""

    env_id: str
    motor_type: str
    control_task: str
    action_type: str
    tau: float
    # indices into the full state vector
    current_idx: np.ndarray
    voltage_idx: np.ndarray
    omega_idx: int
    torque_idx: int
    angle_idx: int | None
    limits: np.ndarray
    # CC gains
    cc_p_gain: np.ndarray
    cc_i_gain: np.ndarray
    cc_d_gain: np.ndarray | None
    cc_action_range: tuple
    cc_mode: str = "pi"  # 'pi' | 'pid' | 'p' | 'three_point'
    cc_hysteresis: np.ndarray = None
    # EMF feedforward: 'classic' ('ind' and 'eesm' come with their motors)
    decoupling: bool = True
    emf_current_idx: np.ndarray = None
    l_emf: np.ndarray = None
    psi_emf: np.ndarray = None
    pole_pairs: float = 0.0
    emf_kind: str = "classic"
    emf_params: dict = dataclasses.field(default_factory=dict)
    # clipping (CC): 'absolute' | 'squared'
    cc_clip_kind: str = "absolute"
    cc_clip_limits: object = None  # absolute: (lo, hi); squared: limits
    # abc transformation
    transform: bool = False
    transform_clipped: bool = False  # the JAX package's DFIM extension
    advance_factor: float = 0.5
    n_output_voltages: int = 1
    # TC stage
    ops_kind: str | None = None
    ops_params: dict = dataclasses.field(default_factory=dict)
    tc_clip_kind: str = "absolute"
    tc_clip_limits: np.ndarray = None
    # SC stage
    sc_p_gain: np.ndarray = None
    sc_i_gain: np.ndarray = None
    sc_clip_range: tuple = None
    # output stage
    output_kind: str = "cont"  # 'cont' | 'disc' | 'multidisc' | 'b6'
    action_pad: int = 0  # trailing zero channels
    output_limits: np.ndarray = None
    disc_levels: tuple = None  # (low_level, high_level) arrays
    disc_actions: tuple = None  # (low, idle, high) per component
    n_ref: int = 1
    ref_limits: np.ndarray = None
    current_names: tuple = ()  # controlled-current state names, cascade order
    # the two-level bridge's applied voltages per channel (low, high): what
    # the sigma-delta B6 stage integrates against
    applied_levels: tuple = None

    # ------------------------------------------------------------------
    # Construction / tuning
    # ------------------------------------------------------------------

    @classmethod
    def make(cls, env, env_id=None, decoupling=True, current_safety_margin=0.2, a=4,
             base_current_controller="PI"):
        """gem_controller.py:29-99 upstream + the per-stage tune() calls.

        ``env_id`` may be omitted: the action type, control task and motor
        type are then detected from the environment itself."""
        if env_id is None:
            env_id = _detect_env_id(env)
        action_type, control_task, motor_type = readers.split_env_id(env_id)
        if motor_type == "SRM":
            # the dq cascade does not apply to a switched-reluctance machine:
            # route to the commutation controller (an extension of the JAX
            # package; `a` maps to the same symmetric-optimum damping)
            from .srm import SRMCommutationController

            return SRMCommutationController.make(
                env, env_id, current_safety_margin=current_safety_margin, a=a)
        state_names, limits, low, high = _state_arrays(env)
        mtr = motor_type
        if mtr in readers.induction_motors and "psi_abs" not in state_names:
            # the JAX package's check (emf_feedforward_ind.py:23-45 upstream)
            raise ValueError(f"{mtr} control requires a FluxObserver wrapper "
                             f"('psi_abs' state missing)")
        reason = _unported(mtr, control_task)
        if reason is not None or mtr in readers.induction_motors:
            raise NotImplementedError(reason or (
                f"{mtr} control needs the FluxObserver wrapper and "
                "controllers/induction_eesm_ops.py, which the port does not have yet"))
        tau = env.physical_system.tau

        currents = readers.currents[mtr]
        voltages = readers.voltages[mtr]
        current_idx = np.array([state_names.index(c) for c in currents])
        voltage_idx = np.array([state_names.index(v) for v in voltages])
        omega_idx = state_names.index("omega")
        torque_idx = state_names.index("torque")

        # --- CC: PI gains by the symmetric optimum (pi_controller.py:60-86)
        l_ = readers.l_reader[mtr](env)
        cc_p = l_ / (tau * a)
        cc_i = cc_p / (tau * a**2)
        cc_mode = {"PI": "pi", "PID": "pid", "P": "p",
                   "ThreePoint": "three_point"}[base_current_controller]
        if cc_mode == "p":
            cc_i = np.zeros_like(cc_i)
        cc_d = cc_p * tau if cc_mode == "pid" else None
        v_lims = limits[voltage_idx]
        cc_range = (low[voltage_idx] * v_lims, high[voltage_idx] * v_lims)
        # three-point hysteresis: 1% of the voltage range
        cc_hysteresis = 0.01 * (cc_range[1] - cc_range[0])

        # --- EMF feedforward (emf_feedforward.py:80-103)
        emf_idx = np.array([state_names.index(c) for c in readers.emf_currents[mtr]])
        l_emf = readers.l_emf_reader[mtr](env)
        psi_emf = readers.psi_reader[mtr](env)
        p = float(readers.p_reader[mtr](env))

        # --- CC clipping (pi_current_controller.py:99-106)
        if mtr in readers.ac_motors:
            cc_clip_kind = "squared"
            cc_clip_limits = v_lims
        else:
            cc_clip_kind = "absolute"
            cc_clip_limits = np.stack(cc_range)

        # --- abc transformation
        transform = mtr in readers.ac_motors
        angle_idx = state_names.index("epsilon") if transform else None
        out_volt_names = readers.get_output_voltages(mtr, action_type)
        n_out = len(out_volt_names)

        ctrl = cls(
            env_id=env_id, motor_type=mtr, control_task=control_task,
            action_type=action_type, tau=tau,
            current_idx=current_idx, voltage_idx=voltage_idx,
            omega_idx=omega_idx, torque_idx=torque_idx, angle_idx=angle_idx,
            limits=limits,
            cc_p_gain=cc_p, cc_i_gain=np.clip(cc_i, 0.0, np.inf), cc_d_gain=cc_d,
            cc_action_range=cc_range, cc_mode=cc_mode, cc_hysteresis=cc_hysteresis,
            decoupling=decoupling, emf_current_idx=emf_idx, l_emf=l_emf,
            psi_emf=psi_emf, pole_pairs=p, emf_kind="classic", emf_params={},
            cc_clip_kind=cc_clip_kind, cc_clip_limits=cc_clip_limits,
            transform=transform, transform_clipped=False,
            advance_factor=0.5, n_output_voltages=n_out,
            current_names=tuple(currents),
        )

        # --- TC stage (torque_controller.py:94-111)
        if control_task in ("TC", "SC"):
            ctrl._tune_torque_stage(env, current_safety_margin, limits, low, high)
        # --- SC stage (pi_speed_controller.py:86-100)
        if control_task == "SC":
            j_total = float(env.physical_system.load.j_load
                            + env.physical_system.motor.parameter["j_rotor"])
            t_n = float(np.min(ctrl.cc_p_gain / ctrl.cc_i_gain))
            sc_p = j_total / (a * t_n)
            ctrl.sc_p_gain = np.array([sc_p])
            ctrl.sc_i_gain = np.array([sc_p / (a * t_n)])
            t_lim = limits[torque_idx]
            ctrl.sc_clip_range = (
                np.array([low[torque_idx] * t_lim]),
                np.array([high[torque_idx] * t_lim]),
            )

        # --- output stage
        ctrl._tune_output_stage(env, state_names, limits, low, high, out_volt_names)

        # --- reference input scaling (input_stage.py:42-58)
        ref_idx = [state_names.index(r) for r in env.reference_names]
        ctrl.n_ref = len(ref_idx)
        ctrl.ref_limits = limits[np.array(ref_idx)]
        return ctrl

    def _tune_torque_stage(self, env, margin, limits, low, high):
        """The DC motors' analytic operating-point selection
        (permex/series/shunt/extex_dc_ops.py upstream)."""
        mtr = self.motor_type
        if mtr not in readers.dc_motors:
            raise NotImplementedError(_unported(mtr, self.control_task))
        cur_lims = limits[self.current_idx] * (1 - margin)
        self.tc_clip_kind = "absolute"
        self.tc_clip_limits = np.stack(
            (low[self.current_idx] * cur_lims, high[self.current_idx] * cur_lims))
        mp = env.physical_system.motor.parameter
        names = list(env.physical_system.state_names)
        if mtr == "PermExDc":
            self.ops_kind = "permex"
            self.ops_params = dict(
                psi=float(mp["psi_e"]),
                v_lim=float(limits[self.voltage_idx][0]),
                r=float(mp["r_a"]),
            )
        elif mtr == "SeriesDc":
            self.ops_kind = "series"
            self.ops_params = dict(l_prime=float(mp["l_e_prime"]))
        elif mtr == "ShuntDc":
            self.ops_kind = "shunt"
            i_lims = limits[self.current_idx] * (1 - margin)
            i_e_idx = names.index("i_e")
            self.ops_params = dict(
                l_prime=float(mp["l_e_prime"]),
                i_a_limit=float(i_lims[0]),
                i_e_limit=float(limits[i_e_idx] * (1 - margin)),
                i_e_idx=i_e_idx,
            )
        else:  # ExtExDc
            self.ops_kind = "extex"
            self.ops_params = dict(
                l_prime=float(mp["l_e_prime"]),
                r_a_sqrt=float(np.sqrt(mp["r_a"])),
                r_e_sqrt=float(np.sqrt(mp["r_e"])),
                i_e_idx=names.index("i_e"),
            )

    def _tune_output_stage(self, env, state_names, limits, low, high, out_volt_names):
        out_idx = np.array([state_names.index(v) for v in out_volt_names])
        self.output_limits = limits[out_idx]
        n_out = len(out_idx)
        space = env.physical_system.action_space
        if self.action_type == "Cont":
            self.output_kind = "cont"
            self.action_pad = len(space[1]) - n_out
            return
        # Finite (disc_output_stage.py:118-160)
        v_range_low = low[out_idx] * self.output_limits
        v_range_high = high[out_idx] * self.output_limits
        low_level = -0.33 * (v_range_high - v_range_low)
        high_level = 0.33 * (v_range_high - v_range_low)
        self.disc_levels = (low_level, high_level)
        self.applied_levels = (v_range_low, v_range_high)
        kind = space[0]
        if kind == "discrete":
            n = space[1]
            if n == 8:
                self.output_kind = "b6"
            else:
                self.output_kind = "disc"
                # disc_output_stage.py:163-171
                self.disc_actions = ((0 if n == 2 else 2), 0, 1)
        elif kind == "multidiscrete":
            self.output_kind = "multidisc"
            acts = []
            pos = 0
            for n in space[1]:
                if pos >= n_out:
                    acts.append("zero")
                elif n == 8:
                    acts.append("b6")
                    pos += 3
                else:
                    acts.append(((0 if n == 2 else 2), 0, 1))
                    pos += 1
            self.disc_actions = tuple(acts)
        else:
            raise ValueError(f"Unsupported finite action space {space}")

    @classmethod
    def from_numpy(cls, fields: dict):
        """The port's controller from the JAX controller's fields, as numpy
        data (``vars(jax_ctrl)``): the tuned constants of one package held
        against the control law of the other.  Unknown keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _host(v) for k, v in fields.items() if k in names})

    @staticmethod
    def state_from_numpy(cs: dict, device):
        """A controller state from the JAX one's entries as numpy arrays
        (``(N, ...)`` under vmap), as float32 tensors on ``device``."""
        return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
                for k, v in cs.items()}

    # ------------------------------------------------------------------
    # Batched tensor functions
    # ------------------------------------------------------------------

    def _consts(self, device):
        """The control law's constants as float32 tensors on ``device``
        (built once per device)."""
        cache = self.__dict__.setdefault("_device_consts", {})
        if device in cache:
            return cache[device]

        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=_f32), device=device)

        k = {"limits": t(self.limits), "ref_limits": t(self.ref_limits),
             "cc_p": t(self.cc_p_gain), "cc_i": t(self.cc_i_gain),
             "cc_range": (t(self.cc_action_range[0]), t(self.cc_action_range[1])),
             "l_emf": t(self.l_emf), "psi_emf": t(self.psi_emf),
             "current_idx": torch.as_tensor(np.asarray(self.current_idx), device=device),
             "emf_idx": torch.as_tensor(np.asarray(self.emf_current_idx), device=device),
             "inv_out": t(_recip(self.output_limits))}
        if self.cc_d_gain is not None:
            k["cc_d"] = t(self.cc_d_gain)
        if self.cc_hysteresis is not None:
            k["cc_h"] = t(self.cc_hysteresis)
        for name, kind, lims in (("cc_clip", self.cc_clip_kind, self.cc_clip_limits),
                                 ("tc_clip", self.tc_clip_kind, self.tc_clip_limits)):
            if lims is None:
                continue
            if kind == "absolute":
                k[name] = (t(np.asarray(lims)[0]), t(np.asarray(lims)[1]))
            elif kind == "squared":
                k[name] = t(_recip(lims))
            else:
                raise NotImplementedError(f"{kind!r} clipping comes with the EESM cascade")
        if self.control_task == "SC":
            k["sc_p"], k["sc_i"] = t(self.sc_p_gain), t(self.sc_i_gain)
            k["sc_clip"] = (t(self.sc_clip_range[0]), t(self.sc_clip_range[1]))
        if self.disc_levels is not None:
            lo, hi = (np.asarray(x, dtype=np.float64) for x in self.disc_levels)
            k["disc_lo"], k["disc_hi"] = t(lo), t(hi)
            k["disc_mid"] = t(0.5 * (lo + hi))
            k["applied"] = (t(self.applied_levels[0]), t(self.applied_levels[1]))
        cache[device] = k
        return k

    def reset(self, n_envs: int = 1, device=None):
        """The initial controller state of ``n_envs`` envs: the PI
        integrators (and the sigma-delta accumulators of a B6 output), on
        ``device`` (``cuda`` unless named, as every entry point)."""
        device = resolve_device(device)

        def zeros(m):
            return torch.zeros((n_envs, m), dtype=torch.float32, device=device)

        cs = {"cc_integrator": zeros(len(self.current_idx))}
        if self.cc_d_gain is not None:
            cs["cc_last_error"] = zeros(len(self.current_idx))
        if self.control_task == "SC":
            cs["sc_integrator"] = zeros(1)
        nb6 = 0
        if self.output_kind == "b6":
            nb6 = 3
        elif self.output_kind == "multidisc":
            nb6 = 3 * sum(1 for a in self.disc_actions if a == "b6")
        if nb6:
            cs["b6_acc"] = zeros(nb6)
        return cs

    @staticmethod
    def _clip(kind, lims, ref):
        """``(clipped, ref - clipped)``: per channel into ``lims`` = (lo, hi)
        (absolute), or the whole vector divided by its squared relative norm
        where that reaches 1 (squared, ``lims`` the reciprocal limits)."""
        if kind == "absolute":
            clipped = torch.minimum(torch.maximum(ref, lims[0]), lims[1])
        else:  # squared_clipping_stage.py:35-53
            rel = ((ref * lims) ** 2).sum(dim=-1, keepdim=True)
            clipped = torch.where(rel < 1.0, ref, ref / rel)
        return clipped, ref - clipped

    def control(self, cs, state_norm, reference_norm, collect_internals=False):
        """One control cycle of ``N`` envs: normalized ``(N, n_state)``
        states and ``(N, n_ref)`` references -> the env actions (``(N,)``
        int32 for a discrete converter, ``(N, n_sub)`` int32 for a
        multidiscrete one, ``(N, n_channels)`` float32 duties otherwise).

        With ``collect_internals`` it also returns the cascade's internal
        references (the clipped torque* after the speed stage, the current*
        vector after operating-point selection)."""
        if self.emf_kind != "classic" or self.transform_clipped:
            raise NotImplementedError(
                "the induction and EESM control laws need controllers/induction_eesm_ops.py, "
                "which the port does not have yet")
        k = self._consts(state_norm.device)
        cs = dict(cs)
        internals = {}
        state = state_norm * k["limits"]
        ref = reference_norm * k["ref_limits"]

        # ---- SC: speed -> torque (pi_speed_controller.py:102-121)
        if self.control_task == "SC":
            omega = state[:, self.omega_idx:self.omega_idx + 1]
            err = ref - omega
            torque_ref = k["sc_p"] * err + k["sc_i"] * cs["sc_integrator"]
            t_clipped, t_diff = self._clip("absolute", k["sc_clip"], torque_ref)
            cs["sc_integrator"] = cs["sc_integrator"] + self.tau * err * (t_diff == 0.0)
            ref = t_clipped
            if collect_internals:
                internals["torque"] = ref[:, 0]

        # ---- TC: torque -> currents (torque_controller.py:113-136)
        if self.control_task in ("TC", "SC"):
            ref = self._operation_point(state, ref[:, 0])
            ref, _ = self._clip(self.tc_clip_kind, k["tc_clip"], ref)
            if collect_internals:
                internals["currents"] = ref

        # ---- CC: currents -> voltages (pi_current_controller.py:146-177)
        i_meas = state[:, k["current_idx"]]
        err = ref - i_meas
        if self.cc_mode == "three_point":
            # hysteresis selection (three_point_controller.py:95-101)
            lo, hi = k["cc_range"]
            u = torch.where(i_meas + k["cc_h"] < ref, hi,
                            torch.where(i_meas - k["cc_h"] > ref, lo, torch.zeros_like(hi)))
        else:
            u = k["cc_p"] * err + k["cc_i"] * cs["cc_integrator"]
            if self.cc_d_gain is not None:
                u = u + k["cc_d"] * (err - cs["cc_last_error"]) * float(_recip(self.tau))
                cs["cc_last_error"] = err
        if self.decoupling:
            u = self._emf_feedforward(k, state, u)
        _u_clipped, u_diff = self._clip(self.cc_clip_kind, k["cc_clip"], u)
        # anti-windup before the output: integrate only unclipped channels
        # (anti_windup.py:49-59)
        cs["cc_integrator"] = cs["cc_integrator"] + self.tau * err * (u_diff == 0.0)

        # ---- abc transformation on the *unclipped* voltage
        if self.transform:
            adv = (state[:, self.angle_idx]
                   + self.advance_factor * self.tau * state[:, self.omega_idx])
            abc = dq_to_abc(u[:, :2], adv)
            u_out = torch.cat([abc, u[:, 2:]], dim=1) if u.shape[1] > 2 else abc
        else:
            u_out = u

        # ---- output stage
        cs, action = self._output(k, cs, u_out)
        if collect_internals:
            return cs, action, internals
        return cs, action

    def _emf_feedforward(self, k, state, u):
        """EMF decoupling (emf_feedforward.py:80-88 upstream)."""
        i_emf = state[:, k["emf_idx"]]
        omega_el = state[:, self.omega_idx:self.omega_idx + 1] * self.pole_pairs
        return u + (k["l_emf"] * i_emf + k["psi_emf"]) * omega_el

    def _operation_point(self, state, t):
        """The DC motors' analytic operating points for the torque ``t``
        (``(N,)``): ``(N, n_currents)`` current references."""
        p = self.ops_params
        kind = self.ops_kind
        if kind == "permex":
            # the reference's speed-dependent current cap is dead code
            # upstream (permex_dc_ops.py:71-81): i_ref = T / psi, uncapped
            return (t * float(_recip(p["psi"])))[:, None]
        if kind == "series":
            return torch.sqrt(torch.clamp(t, min=0.0) * float(_recip(p["l_prime"])))[:, None]
        if kind == "shunt":
            i_e = state[:, p["i_e_idx"]]
            i_e_safe = torch.where(torch.abs(i_e) < 1e-4,
                                   torch.sign(i_e) * 1e-4 + (i_e == 0) * 1e-4, i_e)
            i_ref = t * float(_recip(p["l_prime"])) / i_e_safe
            i_ref = torch.where(i_e > p["i_e_limit"], torch.full_like(i_ref, -p["i_a_limit"]),
                                i_ref)
            i_ref = torch.where(i_e < -p["i_e_limit"], torch.full_like(i_ref, p["i_a_limit"]),
                                i_ref)
            return i_ref[:, None]
        if kind == "extex":
            i_e_ref = torch.sqrt(p["r_a_sqrt"] * torch.abs(t)
                                 * float(_recip(p["r_e_sqrt"] * p["l_prime"])))
            i_a_ref = (t * float(_recip(p["l_prime"]))
                       / torch.clamp(state[:, p["i_e_idx"]], min=1e-4))
            return torch.stack([i_a_ref, i_e_ref], dim=1)
        raise NotImplementedError(_unported(self.motor_type, self.control_task) or kind)

    @staticmethod
    def _b6_action(u3, levels, acc, lo3, hi3):
        """First-order sigma-delta two-level switching -> the Discrete(8)
        index of the B6 subaction table: the per-phase quantization error
        (requested - applied, clamped to one full swing) is integrated and
        compared, so that the applied cycle average tracks the request.  The
        first cycle (acc = 0) is the plain sign comparison."""
        u_eff = u3 + acc
        upper = (u_eff >= levels).to(torch.int32)
        applied = torch.where(upper == 1, hi3, lo3)
        span = hi3 - lo3
        acc_new = torch.minimum(torch.maximum(acc + (u3 - applied), -span), span)
        return 4 * upper[:, 0] + 2 * upper[:, 1] + upper[:, 2], acc_new

    def _output(self, k, cs, u_out):
        if self.output_kind == "cont":
            a = u_out * k["inv_out"]  # cont_output_stage.py:23-24
            if self.action_pad:
                a = torch.cat([a, torch.zeros((a.shape[0], self.action_pad), dtype=a.dtype,
                                              device=a.device)], dim=1)
            return cs, a
        lo_l, hi_l, mid = k["disc_lo"], k["disc_hi"], k["disc_mid"]
        ap_lo, ap_hi = k["applied"]
        if self.output_kind == "b6":
            action, acc = self._b6_action(u_out[:, :3], mid[:3], cs["b6_acc"], ap_lo[:3],
                                          ap_hi[:3])
            cs["b6_acc"] = acc
            return cs, action
        if self.output_kind == "disc":
            low_a, idle_a, high_a = self.disc_actions
            v = u_out[:, 0]
            lvl = torch.where(v <= lo_l[0], low_a, torch.where(v >= hi_l[0], high_a, idle_a))
            return cs, lvl.to(torch.int32)
        # multidisc: map each sub-range of the output voltages
        actions, accs = [], []
        pos = acc_pos = 0
        n = u_out.shape[0]
        for acts in self.disc_actions:
            if acts == "zero":
                actions.append(torch.zeros((n,), dtype=torch.int32, device=u_out.device))
            elif acts == "b6":
                a, acc = self._b6_action(u_out[:, pos:pos + 3], mid[pos:pos + 3],
                                         cs["b6_acc"][:, acc_pos:acc_pos + 3],
                                         ap_lo[pos:pos + 3], ap_hi[pos:pos + 3])
                actions.append(a)
                accs.append(acc)
                pos += 3
                acc_pos += 3
            else:
                low_a, idle_a, high_a = acts
                v = u_out[:, pos]
                a = torch.where(v <= lo_l[pos], low_a,
                                torch.where(v >= hi_l[pos], high_a, idle_a))
                actions.append(a.to(torch.int32))
                pos += 1
        if accs:
            cs["b6_acc"] = torch.cat(accs, dim=1)
        return cs, torch.stack(actions, dim=1)

    # ------------------------------------------------------------------
    # Closed loop (gem_controller.py:144-173 upstream)
    # ------------------------------------------------------------------

    def control_environment(self, env, n_steps, seed=0, n_envs=None, collect_internals=False):
        """Run the tuned controller against its environment on the env's
        device: ``n_envs`` envs (one if None) reset from ``seed``, stepped
        with auto-reset, the controller state carried across episode
        boundaries.

        Returns a dict of stacked per-step tensors: ``states`` and
        ``references`` (the observations after each step), ``rewards`` and
        ``terminations``; ``(n_envs, n_steps, ...)`` with ``n_envs``, and
        ``(n_steps, ...)`` without.  ``collect_internals`` adds
        ``cascade_references``: the subordinate stages' denormalized
        setpoints per step (torque*, the current vector*)."""
        return run_closed_loop(self, env, n_steps, seed, n_envs, collect_internals)


def run_closed_loop(ctrl, env, n_steps, seed, n_envs, collect_internals):
    """The shared closed loop of ``GemController`` and
    ``SRMCommutationController`` (``control_environment``)."""
    n = 1 if n_envs is None else int(n_envs)
    device = env.device
    state, (obs, ref_obs) = env.reset(rng.env_keys(seed, n, device))
    cs = ctrl.reset(n, device)
    rec = {"states": [], "references": [], "rewards": [], "terminations": []}
    ints = {}
    for _ in range(n_steps):
        if collect_internals:
            cs, action, step_ints = ctrl.control(cs, obs, ref_obs, True)
            for key, v in step_ints.items():
                ints.setdefault(key, []).append(v)
        else:
            cs, action = ctrl.control(cs, obs, ref_obs)
        state, (obs, ref_obs), reward, term = env.step_autoreset(state, action)
        for key, v in zip(rec, (obs, ref_obs, reward, term)):
            rec[key].append(v)

    def stack(xs):
        out = torch.stack(xs, dim=1)
        return out[0] if n_envs is None else out

    out = {key: stack(v) for key, v in rec.items()}
    if collect_internals:
        out["cascade_references"] = {key: stack(v) for key, v in ints.items()}
    return out
