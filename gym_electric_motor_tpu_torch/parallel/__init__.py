"""Policies and trainers (counterpart of ``gym_electric_motor_tpu/parallel``,
one device so far)."""

from .sharded import (
    ActorCritic,
    Policy,
    actor_critic,
    init_actor_critic_params,
    init_policy_params,
    make_fused_ppo_trainer,
    params_from_numpy,
    policy_logits,
    policy_obs,
    policy_params_from_numpy,
)

__all__ = [
    "ActorCritic",
    "Policy",
    "actor_critic",
    "init_actor_critic_params",
    "init_policy_params",
    "make_fused_ppo_trainer",
    "params_from_numpy",
    "policy_logits",
    "policy_obs",
    "policy_params_from_numpy",
]
