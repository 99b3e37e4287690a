"""Per-motor-type parameter readers for controller tuning.

The port's own copy of ``gym_electric_motor_tpu/controllers/readers.py``
(numpy only; the port imports nothing of the JAX package), which mirrors
the reference's ``gem_controllers/parameter_reader.py``: small lambdas
extracting inductances, fluxes, resistances, time constants and
state-name groups from a built environment.  ``env`` here is a
:class:`gym_electric_motor_tpu_torch.core.ElectricMotorEnvironment` whose
``physical_system.motor.parameter`` dict plays the role of the reference's
``electrical_motor.motor_parameter``.

Extension beyond the reference: the DFIM rows.  Upstream lists "DFIM" in the
``induction_motors`` group (parameter_reader.py:7) but omits it from every
reader dict.  The JAX package controls the DFIM as a rotor-shorted
induction machine, so every DFIM row mirrors the SCIM row; the rows are
kept here so that the two copies stay the same tables.
"""

import numpy as np

dc_motors = ["SeriesDc", "ShuntDc", "PermExDc", "ExtExDc"]
synchronous_motors = ["PMSM", "SynRM", "EESM"]
induction_motors = ["DFIM", "SCIM"]
ac_motors = synchronous_motors + induction_motors


def _mp(env):
    return env.physical_system.motor.parameter


# parameter_reader.py:15-24
psi_reader = {
    "SeriesDc": lambda env: np.array([0.0]),
    "ShuntDc": lambda env: np.array([0.0]),
    "PermExDc": lambda env: np.array([_mp(env)["psi_e"]]),
    "ExtExDc": lambda env: np.array([0.0, 0.0]),
    "PMSM": lambda env: np.array([0.0, _mp(env)["psi_p"]]),
    "SynRM": lambda env: np.array([0.0, 0.0]),
    "SCIM": lambda env: np.array([0.0, 0.0]),
    "DFIM": lambda env: np.array([0.0, 0.0]),
    "EESM": lambda env: np.array([0.0, 0.0, 0.0]),
}

# parameter_reader.py:26-35
p_reader = {
    "SeriesDc": lambda env: 1,
    "ShuntDc": lambda env: 1,
    "ExtExDc": lambda env: 0,
    "PermExDc": lambda env: 0,
    "PMSM": lambda env: _mp(env)["p"],
    "SynRM": lambda env: _mp(env)["p"],
    "SCIM": lambda env: _mp(env)["p"],
    "DFIM": lambda env: _mp(env)["p"],
    "EESM": lambda env: _mp(env)["p"],
}

# parameter_reader.py:37-95
l_reader = {
    "SeriesDc": lambda env: np.array([_mp(env)["l_a"] + _mp(env)["l_e"]]),
    "ShuntDc": lambda env: np.array([_mp(env)["l_a"]]),
    "ExtExDc": lambda env: np.array([_mp(env)["l_a"], _mp(env)["l_e"]]),
    "PermExDc": lambda env: np.array([_mp(env)["l_a"]]),
    "PMSM": lambda env: np.array([_mp(env)["l_d"], _mp(env)["l_q"]]),
    "SynRM": lambda env: np.array([_mp(env)["l_d"], _mp(env)["l_q"]]),
    "SCIM": lambda env: np.array(
        [(_mp(env)["l_sigr"] + _mp(env)["l_m"]) / _mp(env)["r_r"]] * 2
    ),
    "DFIM": lambda env: np.array(
        [(_mp(env)["l_sigr"] + _mp(env)["l_m"]) / _mp(env)["r_r"]] * 2
    ),
    "EESM": lambda env: np.array([_mp(env)["l_d"], _mp(env)["l_q"], _mp(env)["l_e"]]),
}


def _scim_l_emf(env):
    mp = _mp(env)
    num = (mp["l_sigs"] * mp["l_sigr"] + mp["l_sigs"] * mp["l_m"]
           + mp["l_sigr"] * mp["l_m"])
    den = mp["l_sigr"] + mp["l_m"]
    return np.array([-num / den, num / den])


# parameter_reader.py:97-152
l_emf_reader = {
    "SeriesDc": lambda env: np.array([_mp(env)["l_e_prime"]]),
    "ShuntDc": lambda env: np.array([_mp(env)["l_e_prime"]]),
    "ExtExDc": lambda env: np.array([_mp(env)["l_e_prime"], 0.0]),
    "PermExDc": lambda env: np.array([0.0]),
    "PMSM": lambda env: np.array([-_mp(env)["l_q"], _mp(env)["l_d"]]),
    "SynRM": lambda env: np.array([-_mp(env)["l_q"], _mp(env)["l_d"]]),
    "SCIM": _scim_l_emf,
    "DFIM": _scim_l_emf,
    "EESM": lambda env: np.array(
        [-_mp(env)["l_q"], _mp(env)["l_d"],
         _mp(env)["l_m"] * _mp(env)["l_q"] / _mp(env)["l_d"]]
    ),
}

# parameter_reader.py:155-222
tau_current_loop_reader = {
    "SeriesDc": lambda env: np.array(
        [(_mp(env)["l_e"] + _mp(env)["l_a"]) / (_mp(env)["r_e"] + _mp(env)["r_a"])]
    ),
    "ShuntDc": lambda env: np.array([_mp(env)["l_a"] / _mp(env)["r_a"]]),
    "ExtExDc": lambda env: np.array(
        [_mp(env)["l_a"] / _mp(env)["r_a"], _mp(env)["l_e"] / _mp(env)["r_e"]]
    ),
    "PermExDc": lambda env: np.array([_mp(env)["l_a"] / _mp(env)["r_a"]]),
    "PMSM": lambda env: np.array(
        [_mp(env)["l_q"] / _mp(env)["r_s"], _mp(env)["l_d"] / _mp(env)["r_s"]]
    ),
    "SynRM": lambda env: np.array(
        [_mp(env)["l_q"] / _mp(env)["r_s"], _mp(env)["l_d"] / _mp(env)["r_s"]]
    ),
    "SCIM": lambda env: np.array(
        [_mp(env)["l_sigs"] / _mp(env)["r_s"], _mp(env)["l_sigr"] / _mp(env)["r_r"]]
    ),
    "DFIM": lambda env: np.array(
        [_mp(env)["l_sigs"] / _mp(env)["r_s"], _mp(env)["l_sigr"] / _mp(env)["r_r"]]
    ),
    "EESM": lambda env: np.array(
        [_mp(env)["l_q"] / _mp(env)["r_s"], _mp(env)["l_d"] / _mp(env)["r_s"],
         _mp(env)["l_e"] / _mp(env)["r_e"]]
    ),
}

# parameter_reader.py:224-270
r_reader = {
    "SeriesDc": lambda env: np.array([_mp(env)["r_a"] + _mp(env)["r_e"]]),
    "ShuntDc": lambda env: np.array([_mp(env)["r_a"]]),
    "ExtExDc": lambda env: np.array([_mp(env)["r_a"], _mp(env)["r_e"]]),
    "PermExDc": lambda env: np.array([_mp(env)["r_a"]]),
    "PMSM": lambda env: np.array([_mp(env)["r_s"]] * 2),
    "SynRM": lambda env: np.array([_mp(env)["r_s"]] * 2),
    "SCIM": lambda env: np.array([_mp(env)["r_s"], _mp(env)["r_r"]]),
    "DFIM": lambda env: np.array([_mp(env)["r_s"], _mp(env)["r_r"]]),
    "EESM": lambda env: np.array([_mp(env)["r_s"], _mp(env)["r_s"], _mp(env)["r_e"]]),
}

# parameter_reader.py:341-351
currents = {
    "SeriesDc": ["i"],
    "ShuntDc": ["i_a"],
    "ExtExDc": ["i_a", "i_e"],
    "PermExDc": ["i"],
    "PMSM": ["i_sd", "i_sq"],
    "SynRM": ["i_sd", "i_sq"],
    "SCIM": ["i_sd", "i_sq"],
    "DFIM": ["i_sd", "i_sq"],
    "EESM": ["i_sd", "i_sq", "i_e"],
}

# parameter_reader.py:352-361
emf_currents = {
    "SeriesDc": ["i"],
    "ShuntDc": ["i_e"],
    "ExtExDc": ["i_e", "i_a"],
    "PermExDc": ["i"],
    "PMSM": ["i_sq", "i_sd"],
    "SynRM": ["i_sq", "i_sd"],
    "SCIM": ["i_sq", "i_sd"],
    "DFIM": ["i_sq", "i_sd"],
    "EESM": ["i_sq", "i_sd", "i_sq"],
}

# parameter_reader.py:364-373
voltages = {
    "SeriesDc": ["u"],
    "ShuntDc": ["u"],
    "ExtExDc": ["u_a", "u_e"],
    "PermExDc": ["u"],
    "PMSM": ["u_sd", "u_sq"],
    "SynRM": ["u_sd", "u_sq"],
    "SCIM": ["u_sd", "u_sq"],
    "DFIM": ["u_sd", "u_sq"],
    "EESM": ["u_sd", "u_sq", "u_e"],
}

# parameter_reader.py:389-404
l_prime_reader = {
    "SeriesDc": lambda env: np.array([_mp(env)["l_e_prime"]]),
    "ShuntDc": lambda env: np.array([_mp(env)["l_e_prime"]]),
    "ExtExDc": lambda env: np.array([_mp(env)["l_e_prime"]]),
    "PermExDc": lambda env: np.array([0.0]),
    "PMSM": lambda env: np.array([0.0, 0.0]),
    "SynRM": lambda env: np.array([-_mp(env)["l_q"], _mp(env)["l_d"]]),
    "SCIM": lambda env: np.array([0.0, 0.0]),
    "DFIM": lambda env: np.array([0.0, 0.0]),
    "EESM": lambda env: np.array([0.0, 0.0, 0.0]),
}


def get_output_voltages(motor_type, action_type):
    """parameter_reader.py:376-387."""
    if motor_type in dc_motors:
        return voltages[motor_type]
    if motor_type in induction_motors:
        return ["u_sa", "u_sb", "u_sc"]
    if motor_type == "EESM":
        return ["u_a", "u_b", "u_c", "u_sup"]
    return ["u_a", "u_b", "u_c"]


def split_env_id(env_id):
    return env_id.split("-")[:3]


def get_action_type(env_id):
    return split_env_id(env_id)[0]


def get_control_task(env_id):
    return split_env_id(env_id)[1]


def get_motor_type(env_id):
    return split_env_id(env_id)[2]
