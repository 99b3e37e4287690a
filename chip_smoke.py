#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gym_electric_motor_tpu_torch) once on an
NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. card     name and power limit (nvidia-smi), CUDA must be available
2. build    nvcc builds the kernels of csrc/ for sm_90a
3. kernels  each of the 4 fused PMSM kernels against its plain PyTorch
            version on the card, 16384 envs x 256 steps (the random
            recorder at its main-path 1024 steps), same inputs/seed;
            pmsm_rollout_random and pmsm_record_random (each
            warp-specialised on its ring) bit for bit (error 0 in every
            env and step, equal mean rewards), each with its design line
            (ring, registers, both roles' issue bound and the issue-slot
            floor)
4. env      the main path: the port's VectorEnv (Finite-CC-PMSM-v0, const
            references, an action buffer, 16384 envs x 40 steps) against
            the buffer rollout and the buffer recorder
5. timings  the general path (VectorEnv.rollout, random actions,
            16384 envs x 1000 steps), the random rollout kernel
            (16384 envs x 65536 steps, with its bound and design line) and
            the random recorder (16384 envs x 1024 steps, ~0.54 GB
            written, with its bound and design line) beside the universal
            sync_record_random on the same id (the ratio of their times),
            with output checks
6. (slice 1's rows of the kernels line: launches on its main path,
   phases 4-5, errors, times)
7. policy    each of the 4 policy kernels (csrc/fused_policy.cu) against
            its plain version at 16384 envs x 256 steps, H 16 (the
            recorder at H 32): greedy/const and categorical/Wiener modes,
            policy_rollout bit for bit (error 0 in every env) there and in
            its ten other instances (H 8, 16, 32 x categorical/greedy x
            Wiener/const) at 64 steps, with its design line (the ring's K,
            producer warps, words and bytes with Wiener references, each
            role's registers, the issue bound and issue-slot floor);
            the categorical/Wiener REINFORCE rollout at the trainer's
            shape, 16384 envs x 1024 steps, gamma 0.99, with its design
            line (the role split's step and trace warps, ring, shared
            memory and setmaxnreg budgets, registers, both roles' counts,
            the issue bound and issue-slot floor);
            policy_record bit for bit (error 0 in every env) there (one
            thread per env), at PPO's 2048 envs x 256 steps (eight lanes an
            env, lane 0 stepping) and at 4096 x 256 (four lanes, each
            stepping), each timed with its design, lanes, blocks,
            registers, bound and issue bound
8. rl_checks the greedy policy rollout against the port's VectorEnv
            driven by the MLP's argmax, and the greedy REINFORCE gradient
            at gamma 0 and 0.97 against torch autograd of the REINFORCE
            surrogate on that trajectory (16384 envs x 100 steps, constant
            references; every env starts from the env's reset state, as
            the JAX tests do)
9.-11. the RL main paths, each with the launch counts set to zero just
            before it and read just after, which must be exactly the
            launches the path makes:
   9. ppo   fused-collection PPO at full width (2048 envs x 256 steps,
            hidden 32, 8 minibatches, 2 epochs): 2 warm-up and 20 timed
            iterations, the collection/update split, reward range,
            parameters moved, |E[log pi] + E[H]| < 0.02 on one batch
   10. rl_timings  the evaluation rollout (16384 x 65536 steps;
            categorical with Wiener references, the ring, and greedy with
            constant references, one thread per env), each with its design
            line and reset share, and 5 iterations of the REINFORCE
            trainer (16384 x 1024 steps)
   11. ppo_learn  tools/torch_ppo_learn.py: 1200 PPO iterations at full
            width must reach a mean reward above -0.11 over the last 10
            and 0.05 above the first 5
12. (the rows of slices 1 and 2 of the kernels line, see 49)
13. sync_kernels  slice 3, the universal synchronous family
            (csrc/fused_sync.cu): for each of the 12 {Finite, Cont} x
            {CC, TC, SC} x {PMSM, SynRM} ids, each of the 4 kernels against
            its plain version at 16384 envs x 64 steps (timed on
            Cont-SC-PMSM-v0, the instance the bounds count); the two
            random kernels again at the recorder's main-path 1024 steps
            on Finite-CC-PMSM-v0 and Cont-SC-PMSM-v0; sync_rollout_random
            and sync_record_random (warp-specialised with Wiener references)
            bit for bit (error 0 in every env) in all of those runs, and
            again on every id with constant references
14.-16. the slice-3 main path, counted from zero:
   14. sync_env  for each id, the port's env (VectorEnv's reset, the env's
            step without autoreset, constant references, an action buffer,
            16384 envs x 40 steps) against the buffer rollout and the buffer
            recorder, both reached through the dispatch
            (make_fused_rollout, make_fused_record_rollout), rtol 1e-4 /
            atol 1e-3 (tests/test_pallas_sync_universal.py:75-77)
   15. sync_dispatch  for each id, make_fused_rollout(env, 200, 16384) and
            make_fused_record_rollout(env, 200, 16384) must launch exactly
            sync_rollout_random and sync_record_random once each and no
            other kernel; output checks (finite, angles in range, the
            recorder's rewards sum to the rollout's, its last step is the
            rollout's final state, references inside their margins)
   16. sync_timings  at 16384 envs: the universal random rollout at 65536
            steps on Finite-CC-PMSM-v0 beside slice 1's pmsm_rollout_random
            on the same id (with its bound, reset share and design line),
            on Finite-CC-PMSM-v0 with constant references
            (the one-thread loop that draws the next step's action ahead)
            and on Cont-SC-PMSM-v0, each with its share of env-steps that
            reset, its design, ring, registers, issue bound and issue-slot
            floor; the universal random recorder at 1024 steps on
            Finite-CC-PMSM-v0 and Cont-SC-PMSM-v0 (GB/s) with its reset
            share and its design line as the rollout's; the general path
            (VectorEnv.rollout, random duty) on Cont-SC-PMSM-v0 at 200 steps;
            the launches of phases 14-16 must be exactly what they make
17. (the rows of slices 1 to 3 of the kernels line, see 49)
18. dc_kernels  slice 4, the universal DC family (csrc/fused_dc.cu,
            csrc/fused_dc_record.cu): for each of the 24 {Finite, Cont} x
            {CC, TC, SC} x {PermExDc, SeriesDc, ShuntDc, ExtExDc} ids, each
            of the 4 kernels against its plain version at 16384 envs x 64
            steps (timed on Cont-SC-ShuntDc-v0, the instance the bounds
            count); the two random kernels again at 1024 steps on
            Finite-CC-PermExDc-v0 and Cont-SC-ShuntDc-v0; dc_rollout_random
            and dc_record_random (warp-specialised with Wiener references)
            bit for bit (error 0 in every env) in all of those runs, and
            again on every id with constant references
19.-21. the slice-4 main path, counted from zero:
   19. dc_env  for each id, the port's env (VectorEnv's reset, the env's
            step without autoreset, constant references, an action buffer,
            16384 envs x 40 steps) against the buffer rollout and the buffer
            recorder, both reached through the dispatch, rtol 1e-4 /
            atol 1e-3 (tests/test_pallas_dc_universal.py:83-85)
   20. dc_dispatch  for each id, make_fused_rollout(env, 200, 16384) and
            make_fused_record_rollout(env, 200, 16384) must launch exactly
            dc_rollout_random and dc_record_random once each and no other
            kernel; output checks as phase 15's
   21. dc_timings  at 16384 envs: the random rollout at 65536 steps on
            Finite-CC-PermExDc-v0 with Wiener and with constant references
            (ConstReference("i", 0.3), bench.py:418-420) and on
            Cont-SC-ShuntDc-v0; the random recorder at 1024 steps on both
            ids (GB/s); the general path (VectorEnv.rollout, the random
            policy of the action space) on Cont-SC-SeriesDc-v0 at 200 steps;
            for each rollout and recorder its reset share, design
            (warp-specialised with Wiener references, one thread per env
            with constant ones) and, warp-specialised, roles, ring (K,
            slots, words, shared-memory bytes), registers and both roles'
            counts, and its issue bound beside the one-thread bound; the
            launches of phases 19-21 must be exactly what they make
22. induction_kernels  slice 5, the universal induction family
            (csrc/fused_induction.cu, csrc/fused_induction_record.cu): for
            each of the 6 {Finite, Cont} x {CC, TC, SC} SCIM ids, each of
            the 4 kernels against its plain version at 16384 envs x 64
            steps (timed on Cont-SC-SCIM-v0, the instance the bounds count);
            the two random kernels again at 1024 steps on Finite-CC-SCIM-v0
            and Cont-SC-SCIM-v0; induction_rollout_random and
            induction_record_random (warp-specialised with Wiener
            references) bit for bit (error 0 in every env) in all of those
            runs, and again on every id with constant references
23.-25. the slice-5 main path, counted from zero:
   23. induction_env  for each id, the port's env (VectorEnv's reset, the
            env's step without autoreset, constant references, an action
            buffer, 16384 envs x 40 steps) against both buffer kernels,
            reached through the dispatch, rtol 1e-4 / atol 2e-3
            (tests/test_pallas_families.py:70-72)
   24. induction_dispatch  for each id, make_fused_rollout(env, 200, 16384)
            and make_fused_record_rollout(env, 200, 16384) must launch exactly
            induction_rollout_random and induction_record_random once each
            and no other kernel; output checks as phase 20's, the currents
            inside the limit circle, and the share of env-steps that reset
   25. induction_timings  at 16384 envs: the random rollout at 65536 steps
            on Cont-TC-SCIM-v0 (bench.py:810-812), Finite-CC-SCIM-v0 and
            Cont-SC-SCIM-v0, and on Cont-TC-SCIM-v0 with constant
            references; the random recorder at 1024 steps on Finite-CC- and
            Cont-SC-SCIM-v0 (GB/s); each with its share of env-steps that
            reset, and for the rollout and the recorder their design, roles,
            ring, registers and issue bound as phase 21's; the general path
            (VectorEnv.rollout, the random policy of the action space) on
            Cont-SC-SCIM-v0 at 200 steps; the launches of phases 23-25 must
            be exactly what they make
26. eesm_kernels  slice 6, the universal EESM family (csrc/fused_eesm.cu,
            csrc/fused_eesm_record.cu): for each of the 6 {Finite, Cont} x
            {CC, TC, SC} EESM ids (three references on the CC ids), each of
            the 4 kernels against its plain version at 16384 envs x 64
            steps (timed on Cont-SC-EESM-v0, the instance the bounds count);
            the two random kernels again at 1024 steps on Finite-CC-EESM-v0
            and Cont-SC-EESM-v0; eesm_rollout_random and eesm_record_random
            (warp-specialised with Wiener references) bit for bit (error 0
            in every env) in all of those runs, and again on every id with
            constant references
27.-29. the slice-6 main path, counted from zero:
   27. eesm_env  for each id, the port's env (VectorEnv's reset, the env's
            step without autoreset, constant references, an action buffer,
            16384 envs x 40 steps) against both buffer kernels, reached
            through the dispatch, rtol 1e-4 / atol 2e-3 (angles modulo
            2 pi, tests/test_pallas_families.py:61-72)
   28. eesm_dispatch  for each id, make_fused_rollout(env, 200, 16384) and
            make_fused_record_rollout(env, 200, 16384) must launch exactly
            eesm_rollout_random and eesm_record_random once each and no
            other kernel; output checks as phase 24's, the currents inside
            their limits, and the share of env-steps that reset
   29. eesm_timings  at 16384 envs: the random rollout at 65536 steps on
            Finite-CC-EESM-v0 (bench.py:773-775), Cont-TC-EESM-v0 and
            Cont-SC-EESM-v0, and on Finite-CC-EESM-v0 with constant
            references; the random recorder at 1024 steps on
            Finite-CC-EESM-v0 and Cont-SC-EESM-v0 (11 and 12 planes, GB/s);
            each with its share of env-steps that reset, and for the rollout
            and the recorder their design, roles, ring, registers and issue
            bound as phase 21's; the general path (VectorEnv.rollout, the
            random policy of the action space) on Cont-SC-EESM-v0 at 200
            steps; the launches of phases 27-29 must be exactly what they
            make
30. dfim_kernels  slice 7, the universal DFIM family (csrc/fused_dfim.cu,
            csrc/fused_dfim_record.cu): for each of the 6 {Finite, Cont} x
            {CC, TC, SC} DFIM ids, each of the 4 kernels against its plain
            version at 16384 envs x 64 steps (timed on Cont-SC-DFIM-v0,
            the instance the bounds count); the two random kernels again at
            1024 steps on Cont-CC-DFIM-v0 and Cont-SC-DFIM-v0;
            dfim_rollout_random and dfim_record_random (warp-specialised
            with Wiener references) bit for bit (error 0 in every env) in
            all of those runs, and again on every id with constant
            references
31.-33. the slice-7 main path, counted from zero:
   31. dfim_env  for each id, the port's env (VectorEnv's reset, the env's
            step without autoreset, constant references, an action buffer,
            16384 envs x 40 steps) against both buffer kernels, reached
            through the dispatch, rtol 1e-4 / atol 2e-3 (angles modulo
            2 pi, tests/test_pallas_families.py:61-72; the env turns the
            rotor voltages by two rotations, the kernels by one)
   32. dfim_dispatch  for each id, make_fused_rollout(env, 200, 16384) and
            make_fused_record_rollout(env, 200, 16384) must launch exactly
            dfim_rollout_random and dfim_record_random once each and no
            other kernel; output checks as phase 28's, the currents inside
            the limit circle, and the share of env-steps that reset
   33. dfim_timings  at 16384 envs: the random rollout at 65536 steps on
            Cont-CC-DFIM-v0 (bench.py:773-775), Finite-CC-DFIM-v0 and
            Cont-SC-DFIM-v0, each with its design, ring, registers, issue
            bound and issue-slot floor; the random recorder at 1024 steps on
            Cont-CC-DFIM-v0 and Cont-SC-DFIM-v0 (15 planes each, GB/s);
            each with its share of env-steps that reset, and for the
            recorder its design, roles, ring, registers and issue bound as
            the rollout's; the general path
            (VectorEnv.rollout, the random policy of the action space) on
            Cont-SC-DFIM-v0 at 200 steps; the launches of phases 31-33 must
            be exactly what they make
34. srm_kernels  slice 8, the universal SRM family (csrc/fused_srm.cu,
            csrc/fused_srm_record.cu): for each of the 6 {Finite, Cont} x
            {CC, TC, SC} SRM ids (three references on the CC ids), each of
            the 4 kernels against its plain version at 16384 envs x 64
            steps (timed on Cont-SC-SRM-v0, the instance the bounds count),
            the start currents in [0, 22) A (the limit is 20 A); the two
            random kernels again at 1024 steps on Finite-CC-SRM-v0 and
            Cont-SC-SRM-v0; all four again with the saturating flux model
            (psi_s = 1.2) on Finite-TC-SRM-v0 and Cont-SC-SRM-v0 (the
            continuous buffer's duties in [-0.5, 0.5), where the stiff
            model stays inside the explicit RK4's stability limit without
            resets, as in tests/test_srm.py:265-305); srm_rollout_random
            (lane groups at constant speed, one thread per env under the
            speed ODE) and srm_record_random (warp-specialised on the ring
            on the continuous ids with Wiener references, one thread per env
            on the finite ones) bit for bit (error 0 in every env) on
            all eight
35.-37. the slice-8 main path, counted from zero:
   35. srm_env  for each id, the port's env (VectorEnv's reset, the env's
            step without autoreset, constant references, an action buffer,
            16384 envs x 40 steps) against both buffer kernels, reached
            through the dispatch, rtol 1e-4 / atol 2e-3 (angles modulo
            2 pi, tests/test_srm.py:145-178; the env divides by 2 pi where
            the kernels multiply by its float32 reciprocal)
   36. srm_dispatch  for each id, make_fused_rollout(env, 200, 16384) and
            make_fused_record_rollout(env, 200, 16384) must launch exactly
            srm_rollout_random and srm_record_random once each and no other
            kernel; output checks as phase 32's, every phase current in
            [0, limit] (the diode clamp) and the angle in [-pi, pi], and the
            share of env-steps that reset
   37. srm_timings  at 16384 envs: the random rollout at 65536 steps on
            Finite-CC-SRM-v0 (bench.py:632, :734), Finite-TC-SRM-v0 and
            Cont-SC-SRM-v0; the random recorder at 1024 steps on
            Finite-CC-SRM-v0 and Cont-SC-SRM-v0 (12 and 11 planes, GB/s);
            each with its share of env-steps that reset, and for the
            rollout its lanes per env (1 under the speed ODE) and, on lane
            groups, registers and the issue bound of four lanes' counts
            beside the bound of the function's own work, for the recorder
            its design line (the ring's K, producer warps, words a step,
            shared bytes, each role's registers and counts, the bound of
            the function's own work, the issue bound of both roles' counts
            and the issue-slot floor); the general
            path (VectorEnv.rollout, the random policy of the action space)
            on Cont-SC-SRM-v0 at 200 steps; the launches of phases 35-37
            must be exactly what they make
38. policy_universal_kernels  slice 9, the universal policy recorder
            (csrc/fused_<family>_policy.cu, one kernel per family): on each
            of the 60 ids at PPO's width (2048 envs x 64 steps, H 32), and
            with joint heads on Finite-CC-{ExtExDc,EESM,DFIM,SRM}-v0, the
            kernel against its plain version (the random-mode rule; timed on
            each family's row id); again at 16384 envs x 256 steps on one id
            per family; and on every id and the four joint heads at the
            main path's own shape and width (phase 41: 1024 envs x 32
            steps, H 16), so that a kernel wrong at another H than 32 fails;
            the six families' recorders (dc_, sync_, eesm_, srm_,
            dfim_ and induction_policy_record, on lane groups at PPO's
            width) against their one-thread designs bit for bit (error 0
            in every env and output) at 2048 x 64 on
            Finite-CC-PermExDc-v0, Cont-CC-PermExDc-v0,
            Finite-CC-ExtExDc-v0 with joint heads, Finite-CC-PMSM-v0,
            Cont-CC-PMSM-v0, Cont-SC-PMSM-v0, Finite-CC-EESM-v0 (and its
            joint head), Cont-SC-EESM-v0, Finite-CC-SRM-v0 (and its joint
            head), Cont-SC-SRM-v0, Finite-TC-SRM-v0 with psi_s = 1.2,
            Finite-CC-DFIM-v0 (and its joint head), Cont-SC-DFIM-v0,
            Finite-CC-SCIM-v0 and Cont-SC-SCIM-v0, with the layout line
            (lanes, lead lane, blocks, SMs)
39. policy_universal_replay  the recorded actions (a continuous id's
            squashed duties) through the buffer recorder on Finite- and
            Cont-CC-{PermExDc,DFIM}-v0 (2048 envs x 32 steps, zero biases):
            the states up to each env's first reset within rtol 1e-4 /
            atol 2e-3, angles modulo 2 pi
40. policy_universal_alignment  on one id per family, the observation
            rebuilt by policy_obs_host and the recorded actions give
            |E[log pi(a|s)] + E[H]| < 0.03 (categorical or Gaussian)
41. the slice-9 main path, its launches counted from zero, with no
    plain-version call: make_fused_ppo_trainer(env) ('auto') trains one
    iteration on every id (1024 envs x 32 steps, H 16), one launch of the
    family's kernel each; tools/torch_ppo_learn.py's two universal
    learning checks (tools/tpu_validate.py:303-365, limits unchanged:
    Finite-CC-PermExDc-v0 200 iterations, Cont-CC-PermExDc-v0 300) and 10
    timed iterations each (collection and update, CUDA events); 'auto' on
    Finite-CC-PMSM-v0 with the RL state filter launches policy_record
42. policy_universal_timings  the recorder at PPO's shape (2048 x 256) and
    at 16384 x 1024, H 32, on Finite-CC-PermExDc-v0, Cont-CC-PermExDc-v0,
    Finite-CC-DFIM-v0 (factorised and joint), Cont-SC-SRM-v0,
    Finite-CC-PMSM-v0, Finite-CC-EESM-v0 and Finite-CC-SCIM-v0, each with
    its bound, reset share and design (lanes, and on lane groups
    registers, a lane's counts, the issue bound of G lanes' counts and the
    issue-slot floor); on Finite-CC-PMSM-v0 beside policy_record in the
    same call
43. control_kernels  slice 10, the classical controllers in the loop
    (csrc/fused_foc.cu, csrc/fused_dc_cascade.cu, csrc/fused_srm_cascade.cu):
    each kernel against its plain version at 16384 envs x 64 steps, with
    constant references (every env, rtol 1e-5 / atol 1e-4) and with the
    catalog's Wiener references (the random-mode rule): the FOC on
    Cont-CC-PMSM-v0, the DC cascade on the three Cont-SC DC ids, the SRM
    cascade on the six SRM ids and, saturating (psi_s = 1.2), on
    Finite-TC-SRM-v0 and Cont-SC-SRM-v0; each again at 1024 steps on one id
    (timed on Cont-CC-PMSM-v0, Cont-SC-PermExDc-v0, Finite-SC-SRM-v0); the
    FOC and the SRM and DC cascades bit for bit (error 0 in every env) in
    every case
44.-45. the slice-10 main path, counted from zero (GemController.make and
    the three builders of ops/fused_rollout.py, no plain version):
   44. control_loops  with constant references at 128 envs, the fused loop
            against the port's control_environment (tests/test_pallas_
            rollout.py:376-415, :790-812, tests/test_srm.py:207-233): the
            FOC 400 steps (currents rtol 1e-5 / atol 1e-3 and at -0.1 and
            0.3 of the env's i_sd / i_sq limits within 0.05 A, mean reward
            rtol 1e-4), the DC
            cascade on Cont-SC-PermExDc-v0 600 steps (omega rtol 1e-5 / atol
            1e-2, mean reward rtol 1e-4), the SRM cascade on Finite-SC- and
            Finite-TC-SRM-v0 600 steps (mean reward atol 2e-5); no
            termination; the DC cascade on each Cont-SC DC id converges to
            0.5 w_lim at rtol 2e-3 in 4000 steps
   45. control_timings  at 16384 envs x 65536 steps (CUDA-event medians of
            5 calls, the catalog's Wiener references), each kernel in one
            call with the open-loop universal kernel on the same id:
            foc_rollout beside sync_rollout_random on Cont-CC-PMSM-v0,
            dc_cascade_rollout beside dc_rollout_random on
            Cont-SC-PermExDc-v0 and alone on Cont-SC-SeriesDc-v0 and
            Cont-SC-ShuntDc-v0, both with their design lines (ring,
            registers, both roles' issue bound and the issue-slot floor),
            srm_cascade_rollout beside srm_rollout_random on Finite-SC- and
            Finite-TC-SRM-v0; each with its SASS bound and the share of it
            reached, and its reset share; control_environment on the
            general path (16384 envs x 200 steps, host clock); the launches
            of phases 44-45 must be exactly what they make
46. specialised_kernels  slice 11, the specialised builders
    (csrc/fused_permex.cu, csrc/fused_dc_sc.cu, csrc/fused_scim_tc.cu,
    csrc/fused_eesm_cc.cu, csrc/fused_dfim_cc.cu; bench.py:790-825): each of
    the 12 kernels against its plain version at 16384 envs x 64 steps on its
    catalog id (the DC SC kernels on Cont-SC-SeriesDc-v0 and
    Cont-SC-ShuntDc-v0, timed on the latter, with the design lines of the
    PermExDc, DC SC, Cont-TC-SCIM, Finite-CC-EESM and Cont-CC-DFIM random
    rollouts and of the PermExDc recorder: ring, registers, issue bound and
    issue-slot floor), the PermExDc recorder again at its main-path 1024
    steps; bit for bit in both modes (error 0 in every env)
47.-48. the slice-11 main path, counted from zero (the six builders of
    ops/fused_rollout.py, no plain version):
   47. specialised_buffer  each builder's buffer mode (and the PermExDc
            recorder's) against the universal buffer kernels, reached
            through the dispatch, on the same id and buffer, 16384 envs x 64
            steps, rtol 1e-5 / atol 1e-4
   48. specialised_timings  at 16384 envs x 65536 steps (CUDA-event medians
            of 5 calls, the builders' Wiener references), each random
            rollout in one call with the universal kernel on the same id,
            the ratio of their times, its SASS bound and reset share (the
            DC SC rollout's design line on both ids, the PermExDc, SCIM TC,
            EESM CC and DFIM CC rollouts' on their ids); the
            PermExDc recorder at 1024 steps beside the universal recorder,
            with its design line;
            output checks (finite, references inside their windows, the
            sub-episode lengths and sigmas, the mean reward within 0.08 of
            the universal kernel's); the launches of phases 47-48 must be
            exactly what they make
49. kernels line (all 53 kernels; a policy kernel's launches are the sum
    over the paths of phases 9-11, listed by path; a sync kernel's those of
    phases 14-16, a DC kernel's those of phases 19-21, an induction
    kernel's those of phases 23-25, an EESM kernel's those of phases
    27-29, a DFIM kernel's those of phases 31-33, an SRM kernel's those of
    phases 35-37, a universal policy kernel's those of phase 41, a
    controller kernel's those of phases 44-45, a specialised kernel's those
    of phases 47-48), after a redesign_order line (every kernel by its
    launches times the time a launch takes above its bound, each with the
    redesign it has had), the card line, then {"ok": true, "device":
    {...}}

REINFORCE's block must match its plain version within 1e-4 of its
largest entry in both modes, and autograd within 1e-4 relative; the PPO and policy
random modes use the random-mode rule below.

Tolerances: buffer modes rtol 1e-5 / atol 1e-4 (A, rad), those of
tests/test_pallas_rollout.py:52-58 (float32 RK4; the kernels are built
with -fmad=false, so each op rounds as PyTorch's do).  Random modes:
an env matches when all its outputs agree at rtol 1e-4 / atol 1e-4; at
least 99.9% of envs must match (a constraint-threshold flip sends an env
down another branch) and the mean reward must agree to 1e-4 relative.
Angles are compared modulo 2 pi.  The specialised kernels (phase 46) must
equal their plain versions bit for bit in every env, both modes, and so
must pmsm_rollout_random and pmsm_record_random (phase 3), the sync, DC,
SCIM, EESM, DFIM and SRM random rollouts (phases 13, 18, 22, 26, 30 and
34), policy_record and policy_rollout (phase 7) and the SRM cascade
(phase 43).

Bounds (bound_ms): the larger of the bytes moved (each input read once,
each output written once) over 3.35 TB/s and, for each issue pipe, the
instructions one step always executes over the pipe's rate, at 132 SMs x
1.98 GHz.  The counts come from the SASS of the library this run built
(tools/sass_ops.py: FP32 operations at 256 per SM and clock, i.e.
67 TFLOP/s; ALU and IMAD instructions at 64; MUFU and conversions at 16;
warp shuffles at 32).  At constant speed the SRM random rollout runs an
env on four lanes (tools/sass_ops.py's @lanes4); its bound counts the
function's own work, the one-thread step of the same instance (built for
the count, never launched), and phase 37 prints the issue bound of four
lanes' counts beside it.  policy_record runs an env on eight lanes at
PPO's width, lane 0 alone stepping (@lanes8: the step is a branch on the
lane, which every warp issues), and on four lanes, each stepping, up to
three blocks an SM (@lanes4); its bound counts the one-thread step, and
phase 7 prints the issue bound of G lanes' counts beside it.
pmsm_rollout_random, pmsm_record_random, the sync, DC, SCIM, EESM and
DFIM random rollouts, policy_rollout, the specialised random rollouts and
the PermExDc recorder run warp-specialised with Wiener references
(tools/sass_ops.py's @ws2 and @ws4); their bound counts the one-thread
step of the same instance (built for the count, not taken by the launch),
and phases 3, 5, 7, 10, 16, 21, 25, 29, 33, 46 and 48 print the issue bound of both roles' counts per env-step beside it.  Beside an issue bound stands the
issue-slot floor: every counted instruction the launch issues (an FFMA
is one) at one warp-instruction per scheduler and clock, 4 x 32
thread-instructions per SM and clock.  Shared-memory accesses and barriers (the smem and bar
pipes, LAYOUT_PIPES) count only in issue bounds.
They leave out the blocks a step runs only sometimes (reference
regeneration, the reset draws of a violation, the slow paths of sqrtf and
sincosf), so each bound is a lower bound; the build phase prints both
counts.  REINFORCE's bound counts its FP32 and XU pipes only (BOUND_PIPES).
The universal policy recorders' hidden-unit loop runs H times a step: their
bound adds its count (tools/sass_ops.py's @inner) H times.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

N_ENVS = 16384
T_COMPARE = 256
T_ENV = 40
T_GENERAL = 500         # short enough to keep the whole script near 350 s
T_ROLLOUT = 65536
T_RECORD = 1024
SEED = 7

# slice 2: RL on Finite-CC-PMSM-v0
SF = ("omega", "i_sd", "i_sq", "epsilon")
H_EVAL, H_PPO = 16, 32
T_RL_ENV = 100         # the RL checks' depth, cut from 200 for the script's time: every check is exact
T_POLICY = 65536
T_POLICY_BIT = 64       # the ten other policy_rollout instances, bit for bit
T_REINFORCE = 1024      # the REINFORCE trainer's depth; one call takes over 10 ms
REINFORCE_ITERS = 5
EVAL_REPS = 5
PPO = dict(hidden=H_PPO, horizon=256, n_envs=2048, n_minibatches=8, n_epochs=2, lr=1e-3,
           gamma=0.9, vf_coef=0.1, ent_coef=0.01)   # bench.py:455-462, tools/tpu_validate.py:282-285
PPO_WARMUP, PPO_ITERS = 2, 20
LEARN_ITERS = 1200      # tools/torch_ppo_learn.py, tools/tpu_validate.py:270-300
# slice 3: the twelve synchronous-family ids
# each family kernel against its plain version on every id; cut from 128 for the script's
# time (every id is still checked, and drift shows in the 1024-step deep checks)
T_SYNC_COMPARE = 64
T_SYNC_ENV = 40
T_DISPATCH = 200
T_SYNC_GENERAL = 200
SYNC_TIMED = "Cont-SC-PMSM-v0"   # the ids whose instances STEP_INSTANCES counts
SYNC_SPECIALISED = "Finite-CC-PMSM-v0"
SYNC_REPS = 5                    # timed calls of each main-path timing
SYNC_CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2)], "TC": [("torque", 0.3)],
                   "SC": [("omega", 0.2)]}
# slice 4: the 24 DC-family ids
DC_TIMED = "Cont-SC-ShuntDc-v0"         # the ids whose instances STEP_INSTANCES counts
DC_BENCH = "Finite-CC-PermExDc-v0"      # bench.py:418-420
DC_GENERAL = "Cont-SC-SeriesDc-v0"
DC_CONST_REFS = {"CC": {"PermExDc": [("i", 0.2)], "SeriesDc": [("i", 0.2)],
                        "ShuntDc": [("i_a", 0.2)], "ExtExDc": [("i_a", 0.2), ("i_e", 0.1)]},
                 "TC": [("torque", 0.3)], "SC": [("omega", 0.2)]}
# slice 5: the six SCIM ids (constant references as slice 3's)
IND_TIMED = "Cont-SC-SCIM-v0"      # the ids whose instances STEP_INSTANCES counts
IND_BENCH = "Cont-TC-SCIM-v0"      # bench.py:810-812
IND_CC = "Finite-CC-SCIM-v0"
# slice 6: the six EESM ids
EESM_TIMED = "Cont-SC-EESM-v0"     # the ids whose instances STEP_INSTANCES counts
EESM_BENCH = "Finite-CC-EESM-v0"   # bench.py:773-775, three references
EESM_TC = "Cont-TC-EESM-v0"
EESM_CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2), ("i_e", 0.3)], "TC": [("torque", 0.3)],
                   "SC": [("omega", 0.2)]}
# slice 7: the six DFIM ids (constant references as slice 3's)
DFIM_TIMED = "Cont-SC-DFIM-v0"     # the ids whose instances STEP_INSTANCES counts
DFIM_BENCH = "Cont-CC-DFIM-v0"     # bench.py:773-775
DFIM_CC = "Finite-CC-DFIM-v0"
# slice 8: the six SRM ids
SRM_TIMED = "Cont-SC-SRM-v0"      # the ids whose instances STEP_INSTANCES counts
SRM_BENCH = "Finite-CC-SRM-v0"    # bench.py:632, :734, three references
SRM_TC = "Finite-TC-SRM-v0"       # the torque reward at the wrapped angle
SRM_SAT = dict(motor=dict(motor_parameter={"psi_s": 1.2}))  # tests/test_srm.py:265-305
SRM_SAT_IDS = ("Finite-TC-SRM-v0", "Cont-SC-SRM-v0")
SRM_CONST_REFS = {"CC": [("i_a", 0.2), ("i_b", 0.3), ("i_c", 0.1)], "TC": [("torque", 0.3)],
                  "SC": [("omega", 0.2)]}
# slice 9: the universal policy recorder (csrc/fused_<family>_policy.cu)
PU_COMPARE = (2048, 64)       # every id against the plain version, at PPO's width
PU_DEEP = (16384, 256)        # one id per family again, deeper
PU_REPLAY = (2048, 32)        # the buffer replay (tests/test_fused_policy_universal.py:205-236)
PU_JOINT_IDS = ("Finite-CC-ExtExDc-v0", "Finite-CC-EESM-v0", "Finite-CC-DFIM-v0",
                "Finite-CC-SRM-v0")
# each family's id: deep compare, alignment, its kernel row (STEP_INSTANCES counts it)
PU_ROW_IDS = {"sync": "Finite-CC-PMSM-v0", "dc": "Finite-CC-PermExDc-v0",
              "induction": "Finite-CC-SCIM-v0", "eesm": "Finite-CC-EESM-v0",
              "dfim": "Finite-CC-DFIM-v0", "srm": "Cont-SC-SRM-v0"}
PU_DEEP_IDS = ("Finite-CC-PMSM-v0", "Cont-CC-PermExDc-v0", "Finite-CC-SCIM-v0",
               "Cont-SC-EESM-v0", "Finite-CC-DFIM-v0", "Cont-SC-SRM-v0")
PU_ALIGN_IDS = ("Finite-CC-PMSM-v0", "Cont-CC-PermExDc-v0", "Finite-CC-SCIM-v0",
                "Cont-SC-EESM-v0", "Finite-CC-DFIM-v0", "Cont-TC-SRM-v0")
PU_REPLAY_IDS = ("Finite-CC-PermExDc-v0", "Finite-CC-DFIM-v0", "Cont-CC-PermExDc-v0",
                 "Cont-CC-DFIM-v0")
# (id, joint heads, the STEP_INSTANCES key of its instance)
PU_TIMED = (("Finite-CC-PermExDc-v0", False, "dc_policy_record"),
            ("Cont-CC-PermExDc-v0", False, "dc_policy_record/Cont-CC-PermExDc-v0"),
            ("Finite-CC-DFIM-v0", False, "dfim_policy_record"),
            ("Finite-CC-DFIM-v0", True, "dfim_policy_record/joint"),
            ("Cont-SC-SRM-v0", False, "srm_policy_record"),
            ("Finite-CC-PMSM-v0", False, "sync_policy_record"),
            ("Finite-CC-EESM-v0", False, "eesm_policy_record"),
            ("Finite-CC-SCIM-v0", False, "induction_policy_record"))
PU_TIMED_SHAPES = ((2048, 256), (16384, 1024))
# the lane-group recorders' designs held against each other (phase 38),
# (id, joint heads, the env's keywords): dc_policy_record on a finite, a
# continuous and a joint-head id, sync_policy_record on a finite id, the
# Gaussian head and the speed ODE, eesm_policy_record on the three-row
# finite id, its joint head and the Gaussian head under the speed ODE,
# srm_policy_record likewise and on the saturating finite TC id,
# dfim_policy_record on the finite dq id, its 64-way joint head and the
# Gaussian head under the speed ODE, induction_policy_record on the finite
# dq id and the Gaussian head under the speed ODE
PU_DESIGN_IDS = (("Finite-CC-PermExDc-v0", False, {}), ("Cont-CC-PermExDc-v0", False, {}),
                 ("Finite-CC-ExtExDc-v0", True, {}), ("Finite-CC-PMSM-v0", False, {}),
                 ("Cont-CC-PMSM-v0", False, {}), ("Cont-SC-PMSM-v0", False, {}),
                 ("Finite-CC-EESM-v0", False, {}), ("Finite-CC-EESM-v0", True, {}),
                 ("Cont-SC-EESM-v0", False, {}), ("Finite-CC-SRM-v0", False, {}),
                 ("Finite-CC-SRM-v0", True, {}), ("Cont-SC-SRM-v0", False, {}),
                 ("Finite-TC-SRM-v0", False, SRM_SAT), ("Finite-CC-DFIM-v0", False, {}),
                 ("Finite-CC-DFIM-v0", True, {}), ("Cont-SC-DFIM-v0", False, {}),
                 ("Finite-CC-SCIM-v0", False, {}), ("Cont-SC-SCIM-v0", False, {}))
PU_MAIN = (1024, 32)          # the main path's per-id PPO shape (phase 41), also compared
H_PU_MAIN = 16                # its hidden width: the trainer's default
PU_ALL_IDS_PPO = dict(horizon=PU_MAIN[1], n_envs=PU_MAIN[0], n_minibatches=4,
                      hidden=H_PU_MAIN)   # one iteration per id
PU_SPLIT_ITERS = 10           # timed PPO iterations (collection and update) per learning id
# The pipes a kernel's bound counts, where not all.  Most of the ALU and
# IMAD instructions of REINFORCE's one-thread step, whose count the bound
# takes, are the 64-bit arithmetic of its 2 P trace addresses in global
# memory, recomputed each step (opaque64 in csrc/policy_step.cuh keeps
# ptxas from hoisting and spilling them): a cost of that kernel's layout,
# not work the function needs, so they stay out of its bound.  The row
# reports the bound over every pipe beside it.
BOUND_PIPES = {"reinforce_rollout": ("fp32", "xu")}

# peak rates (see the module docstring)
SMS, CLOCK, HBM = 132, 1.98e9, 3.35e12

# The lane-group kernels (tools/sass_ops.py's @lanes4 entries): lanes per
# env, registers (ptxas) and a lane's counts, filled by the build phase.
LANE_KERNELS = {}
# The warp-specialised kernels (tools/sass_ops.py's @ws entries): both
# roles' counts per env-step, each role's own and registers (ptxas), filled
# by the build phase; OPS is every instance's count per step.
WS_KERNELS = {}
OPS = {}
# every instance's counted instructions per step (an FFMA is one), for the
# issue-slot floor
INSNS = {}
# Shared-memory accesses and barriers are a kernel's layout, not the
# function's work: a bound of the function's own work leaves them out (an
# issue bound counts them).
LAYOUT_PIPES = ("smem", "bar")


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(env_steps, ops, nbytes, pipes=None):
    """Least time for ``env_steps`` steps of ``ops`` (per step and pipe, as
    tools/sass_ops.py counts them) moving ``nbytes``.  ``pipes`` (default:
    all but LAYOUT_PIPES) are the pipes that count."""
    from sass_ops import RATE_PER_SM_CLOCK

    pipes = pipes or [k for k in ops if k not in LAYOUT_PIPES]
    t_ops = max(env_steps * ops[k] / (SMS * CLOCK * RATE_PER_SM_CLOCK[k]) for k in pipes)
    t_bytes = nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def floor_fields(env_steps, insns, ms):
    """The issue-slot floor of ``insns`` counted instructions per env-step
    (tools/sass_ops.py's issue_floor_ms) and its share of ``ms``."""
    from sass_ops import issue_floor_ms

    f_ms = issue_floor_ms(env_steps, insns, SMS, CLOCK)
    return {"issue_insns_per_step": insns, "issue_floor_ms": f_ms, "issue_floor_share": f_ms / ms}


def ptxas_registers(log):
    """``{mangled name: registers}`` from an ``nvcc -Xptxas -v`` report."""
    regs, cur = {}, None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            cur = ln.split("Function properties for ", 1)[1].strip()
        elif "Used " in ln and " registers" in ln and cur:
            regs[cur] = int(ln.split("Used ", 1)[1].split()[0])
    return regs


# the lane kernel's STEP_INSTANCES key of a kernel that runs on lane groups
LANE_OF = {"srm_rollout_random": "srm_rollout_lanes", "policy_record": "policy_record_lanes"}


def lane_fields(key, env_steps, nbytes, ms, _c=None):
    """The lane fields of a timed SRM random rollout (phase 37) or of
    policy_record on lane groups (phase 7; ``policy_record/8`` for
    eight lanes): its lanes per env and, on lane groups, registers, a
    lane's counts, the issue bound of G lanes' counts, work that every lane
    repeats included, and the issue-slot floor of their instructions, each
    with its share; one thread per env, the floor of the loop it runs.  The
    row's bound_ms stays the function's own work."""
    base, sep, rest = key.partition("/")
    info = LANE_KERNELS.get(LANE_OF.get(base, base) + sep + rest)
    if info is None:
        return {"lanes": 1, **(floor_fields(env_steps, INSNS[key], ms) if key in INSNS else {})}
    i_ms = bound_ms(env_steps, info["ops"], nbytes, list(info["ops"]))[0]
    return {"lanes": info["lanes"], "registers": info["registers"],
            "ops_per_lane_step": info["per_lane"], "issue_ops_per_step": info["ops"],
            "issue_bound_ms": i_ms, "issue_bound_share": i_ms / ms,
            **floor_fields(env_steps, info["insns"], ms)}


def ring_layout(lib, prefix, c):
    """The random rollout's design and ring for ``c``'s instance and loop,
    from the library itself (csrc/draw_ring.cuh's RingLayout)."""
    import ctypes

    from gym_electric_motor_tpu_torch.ops.fused_common import RING_LAYOUT_FIELDS

    fn = getattr(lib, f"{prefix}_ring_layout")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    out = (ctypes.c_int * len(RING_LAYOUT_FIELDS))()
    if fn(c.flags.ctypes.data, out) != 0:
        raise AssertionError(f"{prefix}_ring_layout refused the flags {list(c.flags)}")
    return dict(zip(RING_LAYOUT_FIELDS, out))


DESIGNS = {0: "warp-specialised", 1: "one thread per env",
           2: "one thread per env, the next step's draws ahead"}

# slice 1's random kernels on rings: their layout function in
# ops/fused_sync.py and their ring's entry in tools/sass_ops.py's
# STEP_INSTANCES
RING_OF = {"pmsm_rollout_random": ("pmsm_ring_layout", "pmsm_rollout_ws"),
           "pmsm_record_random": ("pmsm_record_ring_layout", "pmsm_record_ws")}


def ring_fields(layout, ws_key, loop_key, one_key, env_steps, nbytes, ms, registers=None):
    """The design fields of a timed random rollout: the design its launch
    takes (``layout``, a RingLayout with ``design`` named) and,
    warp-specialised, its ring (K steps a slot, two slots, words a step,
    shared-memory bytes), registers (ptxas: one allocation for both roles
    unless ``registers`` names each role's setmaxnreg budget), each role's
    counts and the issue bound of both roles' counts per env-step
    (``ws_key``), every pipe included, with its share; one thread per env,
    the issue bound of the loop it runs (``loop_key``); and the issue-slot
    floor of the same instructions.  The row's bound_ms stays the
    one-thread step's (``one_key``), the function's own work, repeated here
    as one_thread_bound_ms."""
    out = {"design": layout["design"],
           "one_thread_bound_ms": bound_ms(env_steps, OPS[one_key], nbytes)[0]}
    if layout["design"] == DESIGNS[0]:
        info = WS_KERNELS[ws_key]
        issue, insns = info["ops"], INSNS[ws_key]
        out.update(ring=layout, role_ops=info["roles"],
                   registers=registers or {"consumer": info["registers"],
                                           "producer": info["registers"]})
    else:
        issue, insns = OPS[loop_key], INSNS[loop_key]
    i_ms = bound_ms(env_steps, issue, nbytes, list(issue))[0]
    out.update(ops_per_env_step=issue, issue_bound_ms=i_ms, issue_bound_share=i_ms / ms,
               **floor_fields(env_steps, insns, ms))
    return out


def design_fields(key, env_steps, nbytes, ms, c):
    """``ring_fields`` of a timed sync, DC, SCIM, EESM or DFIM random
    rollout (phases 16, 21, 25, 29 and 33): warp-specialised with Wiener
    references; with constant ones one thread per env, in the one-thread
    kernel's own loop or one that draws the next step's action ahead."""
    from gym_electric_motor_tpu_torch.ops import cuda_build

    prefix = key.split("_", 1)[0]
    layout = ring_layout(cuda_build.load(f"fused_{prefix}"), prefix, c)
    design = layout["design"]
    layout["design"] = DESIGNS[design]
    # the ahead loop: a kernel of its own (the EESM's) or the one-thread
    # kernel's constant-reference loop (the SCIM's and the sync family's)
    ahead = key.replace("_rollout_random", "_rollout_ahead", 1)
    loop = ahead if design == 2 and ahead in OPS else key
    return ring_fields(layout, key.replace("_rollout_random", "_rollout_ws", 1), loop, key,
                       env_steps, nbytes, ms)


def record_design(mod, prefix):
    """The design fields of a timed random recorder of ``mod`` that runs on
    a ring with Wiener references (the sync, DC, SCIM, EESM, DFIM and SRM
    ones; phases 16, 21, 25, 29, 33 and 37), as a function of (key, env_steps,
    nbytes, ms, c): its ring (``<prefix>_record_ring_layout``, with P, the
    producer warps per consumer warp), each role's registers and counts,
    the issue bound of both roles' counts and the issue-slot floor, beside
    the bound of the one-thread step, the function's own work; one thread
    per env, the issue bound of the one-thread loop."""
    def fields(key, env_steps, nbytes, ms, c):
        layout = getattr(mod, f"{prefix}_record_ring_layout")(c)
        if layout["consumer_warps"]:
            layout["P"] = layout["producer_warps"] // layout["consumer_warps"]
        return ring_fields(layout, key.replace("_random", "_ws", 1), key, key, env_steps,
                           nbytes, ms)
    return fields


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, reps):
    """Median device time (ms) of one ``fn()`` call.

    Each call allocates its outputs, as a caller's would.  The two warm-up
    calls leave two output sets in the allocator's cache, so no timed call
    waits on cudaMalloc.  The timed calls are queued back to back, with a
    CUDA event between two calls, behind a few milliseconds of matrix
    products: the host runs ahead, so an event gap is the device's time for
    one call and not the wrapper's host time.  The median drops a call that
    a stall of the host or the card lengthened."""
    out = fn()
    out = fn()
    a = torch.ones((4096, 4096), device="cuda")
    b = torch.empty_like(a)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    for _ in range(4):
        torch.mm(a, a, out=b)
    events[0].record()
    for ev in events[1:]:
        out = fn()
        ev.record()
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:]))
    return times[reps // 2], out


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def angle_err(torch, x, y):
    d = torch.remainder(x - y, 2 * math.pi)
    return torch.minimum(d, 2 * math.pi - d)


def check_buffer(torch, name, got, ref, is_angle):
    """rtol 1e-5 / atol 1e-4 on every element; returns the max abs error."""
    worst = 0.0
    for j, (x, y) in enumerate(zip(got, ref)):
        err = angle_err(torch, x, y) if is_angle[j] else (x - y).abs()
        bad = err > 1e-4 + 1e-5 * y.abs()
        if bool(bad.any()) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: output {j} off tolerance in {int(bad.sum())} "
                                 f"elements, max abs err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    return worst


def env_match(torch, got, ref, is_angle, n_envs):
    """Per-env match at rtol 1e-4 / atol 1e-4 over every output (and every
    step of a recording); returns (share of envs matching, max abs err)."""
    ok = torch.ones(n_envs, dtype=torch.bool, device=got[0].device)
    worst = 0.0
    for j, (x, y) in enumerate(zip(got, ref)):
        x, y = x.float(), y.float()
        err = angle_err(torch, x, y) if is_angle[j] else (x - y).abs()
        bad = (err > 1e-4 + 1e-4 * y.abs()) | ~torch.isfinite(x)
        # envs are the trailing N elements: (R,128), (2R,128) or (T,R,128)
        ok &= ~bad.reshape(-1, n_envs).any(dim=0)
        worst = max(worst, float(err.max()))
    return float(ok.float().mean()), worst


def bit_match(torch, got, ref, n_envs):
    """Bit for bit per env: every element of every output equal, or NaN in
    both (envs are the trailing ``n_envs`` elements, as in env_match);
    returns (share of envs equal, max abs err over the elements that
    differ, 0 where none does)."""
    ok = torch.ones(n_envs, dtype=torch.bool, device=got[0].device)
    worst = 0.0
    for x, y in zip(got, ref):
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        ok &= same.reshape(-1, n_envs).all(dim=0)
        if not bool(same.all()):
            d = (x.double() - y.double()).abs().nan_to_num(nan=math.inf)
            worst = max(worst, float(d[~same].max()))
    return float(ok.float().mean()), worst


def run(dev, card):
    """Phases 2-6 on ``dev``: returns the rows of slice 1's kernels for the
    kernels line and the per-step operation counts; raises on any failure."""
    import numpy as np
    import sass_ops
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import cuda_build
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops.fused_record import make_fused_record_rollout

    # ---- 2. build --------------------------------------------------------
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = cuda_build.build(["fused_pmsm", "fused_policy", "fused_sync", "fused_dc",
                             "fused_dc_record", "fused_induction", "fused_induction_record",
                             "fused_eesm", "fused_eesm_record", "fused_dfim",
                             "fused_dfim_record", "fused_srm", "fused_srm_record",
                             "fused_sync_policy", "fused_dc_policy", "fused_induction_policy",
                             "fused_eesm_policy", "fused_dfim_policy", "fused_srm_policy",
                             "fused_foc", "fused_dc_cascade", "fused_srm_cascade",
                             "fused_permex", "fused_dc_sc", "fused_scim_tc", "fused_eesm_cc",
                             "fused_dfim_cc"])
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip().replace("ptxas info    : ", "")
                    for ln in cuda_build.BUILD_LOG.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln or "Function properties" in ln]
             for name in libs}
    counts, ops = {}, {}
    # one cuobjdump for each library, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        found = dict(zip(sass_ops.STEP_INSTANCES, pool.map(
            lambda item: sass_ops.step_ops(libs[item[0]], list(item[1].values())),
            sass_ops.STEP_INSTANCES.items())))
    sass_s = time.perf_counter() - t0
    for lib, instances in sass_ops.STEP_INSTANCES.items():
        c = found[lib]
        counts.update(c)
        ops.update({k: c[v]["always"] for k, v in instances.items()})
        INSNS.update({k: c[v]["insns"]["always"] for k, v in instances.items()})
        regs = ptxas_registers(cuda_build.BUILD_LOG.get(lib, ""))
        for k, v in instances.items():
            if "ws_steps" in c[v]:
                sub = v.partition("@")[0].partition("#")[0]
                WS_KERNELS[k] = {"ops": c[v]["always"], "ws_steps": c[v]["ws_steps"],
                                 "roles": {r: x["always"] for r, x in c[v]["roles"].items()},
                                 "registers": next((r for f, r in regs.items() if sub in f),
                                                   None)}
            if "lanes" in c[v]:
                sub = v.partition("@")[0]
                LANE_KERNELS[k] = {"lanes": c[v]["lanes"], "per_lane": c[v]["per_lane"]["always"],
                                   "ops": c[v]["always"], "insns": c[v]["insns"]["always"],
                                   "registers": next((r for f, r in regs.items() if sub in f),
                                                     None)}
        # the policy recorders' hidden-unit loop, per hidden unit
        ops.update({k + "/inner": c[v]["inner"]["always"] for k, v in instances.items()
                    if "inner" in c[v]})
    emit({"phase": "build", "seconds": build_s, "nvcc_seconds": cuda_build.BUILD_LOG.get("seconds"),
          "sass_seconds": sass_s, "ptxas": ptxas,
          "ops_per_step": {k: {key: v[key] for key in ("always", "conditional", "insns", "inner",
                                                       "lanes", "lane_branches", "per_lane",
                                                       "roles", "ws_steps", "trace_warps")
                                  if key in v}
                           for k, v in counts.items()},
          "lane_kernels": LANE_KERNELS, "ws_kernels": WS_KERNELS})
    OPS.update(ops)

    R = N_ENVS // 128
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev)
    consts = fs.PmsmConsts(env)
    rng = np.random.default_rng(SEED)
    i_sd0 = torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
    i_sq0 = torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
    eps0 = torch.as_tensor(rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32), device=dev)
    acts = torch.as_tensor(rng.integers(0, 8, (T_COMPARE, R, 128)).astype(np.int32), device=dev)
    state_bytes = 3 * 4 * N_ENVS

    # ---- 3. kernels against their plain versions -------------------------
    # (kernel, plain version, which outputs are angles, steps, bytes moved)
    results = {}
    cases = {
        "pmsm_rollout_buffer": (
            lambda: fs.pmsm_rollout_buffer(consts, i_sd0, i_sq0, eps0, acts),
            lambda: fs.pmsm_rollout_buffer_plain(consts, i_sd0, i_sq0, eps0, acts),
            (False, False, True, False, False), T_COMPARE,
            state_bytes + 4 * N_ENVS * T_COMPARE + 5 * 4 * N_ENVS),
        "pmsm_record_buffer": (
            lambda: fs.pmsm_record_buffer(consts, i_sd0, i_sq0, eps0, acts),
            lambda: fs.pmsm_record_buffer_plain(consts, i_sd0, i_sq0, eps0, acts),
            (False, False, True), T_COMPARE, state_bytes + 16 * N_ENVS * T_COMPARE),
        "pmsm_rollout_random": (
            lambda: fs.pmsm_rollout_random(consts, SEED, i_sd0, i_sq0, eps0, T_COMPARE),
            lambda: fs.pmsm_rollout_random_plain(consts, SEED, i_sd0, i_sq0, eps0, T_COMPARE),
            (False, False, True, False, False, False, False, False, False), T_COMPARE,
            state_bytes + 13 * 4 * N_ENVS),
        "pmsm_record_random": (
            lambda: fs.pmsm_record_random(consts, SEED, i_sd0, i_sq0, eps0, T_RECORD),
            lambda: fs.pmsm_record_random_plain(consts, SEED, i_sd0, i_sq0, eps0, T_RECORD),
            (False, False, True, False, False, False, False, False), T_RECORD,
            state_bytes + 32 * N_ENVS * T_RECORD),
    }
    for name, (kern, plain, is_angle, steps, nbytes) in cases.items():
        ms, got = cuda_ms(torch, kern, reps=21)
        plain_ms, ref = host_ms(torch, plain)
        b_ms, b_by = bound_ms(N_ENVS * steps, ops[name], nbytes)
        row = {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "compare_envs": N_ENVS, "compare_steps": steps}
        if "buffer" in name:
            row["max_abs_err"] = check_buffer(torch, name, got, ref, is_angle)
            row["match_share"] = 1.0
        elif name in RING_OF:
            # the rings: bit for bit in every env and output (the
            # recorder's every step)
            share, worst = bit_match(torch, got, ref, N_ENVS)
            r_idx = 3 if name == "pmsm_rollout_random" else 6
            mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
            layout, ws_key = RING_OF[name]
            row.update(max_abs_err=worst, match_share=share, mean_reward=mean_k,
                       mean_reward_plain=mean_p,
                       **ring_fields(getattr(fs, layout)(), ws_key, name, name,
                                     N_ENVS * steps, nbytes, ms))
            if share < 1.0 or worst != 0.0 or mean_k != mean_p:
                emit({"phase": "kernels", **row})
                raise AssertionError(f"{name}: {share:.5f} of envs equal, max abs err "
                                     f"{worst:.3e} (the ring equals its plain version bit for "
                                     "bit)")
        results[name] = row
        emit({"phase": "kernels", **row})
        del got, ref

    # ---- 4./5. the main path: counts from zero ---------------------------
    fs.reset_launches()

    # 4. env against the buffer kernels
    env_c = gt.make_functional("Finite-CC-PMSM-v0", device=dev, reference_generator=rg.ReferenceSpec(
        [rg.ConstReference("i_sd", 0.0), rg.ConstReference("i_sq", 0.0)]))
    venv = gt.VectorEnv(env_c, N_ENVS)
    state, _obs = venv.reset(SEED)
    env_acts = torch.as_tensor(rng.integers(0, 8, (T_ENV, R, 128)).astype(np.int32), device=dev)
    traj = []
    for t in range(T_ENV):
        state, _obs, _r, term = venv.step(state, env_acts[t].reshape(N_ENVS))
        if bool(term.any()):
            raise AssertionError("env path terminated under the buffer actions")
        traj.append(state.phys.ode_state[:, 1:4])
    ode = torch.stack(traj)  # (T, N, [i_sd, i_sq, eps])
    z = torch.zeros((R, 128), device=dev)
    roll_buf = fs.make_fused_pmsm_rollout(env_c, T_ENV, N_ENVS, action_mode="buffer")
    rec_buf = fs.make_fused_pmsm_record_rollout(env_c, T_ENV, N_ENVS, action_mode="buffer")
    k_final = roll_buf(z, z, z, env_acts)
    k_traj = rec_buf(z, z, z, env_acts)
    env_final = [ode[-1, :, j].reshape(R, 128) for j in range(3)]
    env_traj = [ode[:, :, j].reshape(T_ENV, R, 128) for j in range(3)]
    err_final = check_buffer(torch, "env vs pmsm_rollout_buffer", k_final[:3], env_final,
                             (False, False, True))
    err_traj = check_buffer(torch, "env vs pmsm_record_buffer", k_traj, env_traj,
                            (False, False, True))
    emit({"phase": "env", "envs": N_ENVS, "steps": T_ENV, "max_abs_err_rollout": err_final,
          "max_abs_err_record": err_traj})

    # 5. timings at the bench sizes
    env_w = gt.make_functional("Finite-CC-PMSM-v0", device=dev)
    venv_w = gt.VectorEnv(env_w, N_ENVS)
    state, _obs = venv_w.reset(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    policy = gt.random_policy(8)
    venv_w.rollout(state, policy, 5, gen)  # warm-up
    gen_ms, (state, rsum, tsum) = host_ms(
        torch, lambda: venv_w.rollout(state, policy, T_GENERAL, gen))
    gen_mean_r = float(rsum.double().sum()) / (N_ENVS * T_GENERAL)
    gen_term = float(tsum.double().sum()) / (N_ENVS * T_GENERAL)
    if not math.isfinite(gen_mean_r) or not bool(torch.isfinite(state.phys.ode_state).all()):
        raise AssertionError("general path produced non-finite values")

    roll = fs.make_fused_pmsm_rollout(env_w, T_ROLLOUT, N_ENVS)
    roll_ms, out = cuda_ms(torch, lambda: roll(SEED, z, z, z), reps=5)
    i_sd, i_sq, eps, reward, terms, rv, rk, rl, rs = out
    margin = consts.f["margin"]
    checks = {
        "finite": all(bool(torch.isfinite(x).all()) for x in out),
        "eps_in_range": bool(((eps >= 0) & (eps < 2 * math.pi)).all()),
        "in_current_circle": bool((i_sd ** 2 + i_sq ** 2 <= 400.0 ** 2 * (1 + 1e-5)).all()),
        "ref_in_margin": bool((rv.abs() <= margin * 1.001).all()),
        "lengths": bool(((rl >= 500) & (rl < 2000) & (rk >= 1) & (rk <= rl)).all()),
        "sigma": bool(((rs >= 1e-3 * 0.999) & (rs <= 1e-1 * 1.001)).all()),
    }
    k_mean_r = float(reward.double().sum()) / (N_ENVS * T_ROLLOUT)
    k_term = float(terms.double().sum()) / (N_ENVS * T_ROLLOUT)

    rec = fs.make_fused_pmsm_record_rollout(env_w, T_RECORD, N_ENVS)
    rec_ms, rec_out = cuda_ms(torch, lambda: rec(SEED, z, z, z), reps=5)
    rec_bytes = sum(x.numel() * x.element_size() for x in rec_out)
    # the universal synchronous recorder on the same id, in the same process
    u_rec = make_fused_record_rollout(env_w, T_RECORD, N_ENVS)
    u_rec_ms, u_rec_out = cuda_ms(torch, lambda: u_rec(SEED, z, z, z), reps=5)
    u_rec_reset = float(u_rec_out["done"].double().mean())
    del u_rec_out
    rec_nbytes = state_bytes + 32 * N_ENVS * T_RECORD
    rec_design = ring_fields(fs.pmsm_record_ring_layout(), "pmsm_record_ws", "pmsm_record_random",
                             "pmsm_record_random", N_ENVS * T_RECORD, rec_nbytes, rec_ms)
    short = fs.make_fused_pmsm_rollout(env_w, T_RECORD, N_ENVS)(SEED, z, z, z)
    checks["record_equals_rollout"] = bool(
        torch.allclose(rec_out[6].sum(0), short[3], rtol=1e-4, atol=1e-3)
        and torch.equal(rec_out[0][-1], short[0]))
    # the same process in distribution: general path vs kernel (the bounds
    # of tests/test_pallas_rollout.py:202-204)
    short_r = float(short[3].double().sum()) / (N_ENVS * T_RECORD)
    checks["general_vs_kernel_reward"] = abs(gen_mean_r - short_r) < 0.05
    rec_reset = float(rec_out[7].double().mean())
    del rec_out, short

    launches = {name: fs.LAUNCHES[name] for name in fs.KERNELS}
    roll_bytes = state_bytes + 52 * N_ENVS
    roll_design = ring_fields(fs.pmsm_ring_layout(), "pmsm_rollout_ws", "pmsm_rollout_random",
                              "pmsm_rollout_random", N_ENVS * T_ROLLOUT, roll_bytes, roll_ms)
    emit({"phase": "timings", "card": card,
          "general_path": {"envs": N_ENVS, "steps": T_GENERAL, "ms": gen_ms,
                           "env_steps_per_s": N_ENVS * T_GENERAL / (gen_ms / 1e3),
                           "mean_reward": gen_mean_r, "term_rate": gen_term},
          "pmsm_rollout_random": {
              "envs": N_ENVS, "steps": T_ROLLOUT, "ms": roll_ms,
              "env_steps_per_s": N_ENVS * T_ROLLOUT / (roll_ms / 1e3),
              "mean_reward": k_mean_r, "term_rate": k_term,
              "bound_ms": bound_ms(N_ENVS * T_ROLLOUT, ops["pmsm_rollout_random"], roll_bytes)[0],
              **roll_design},
          "pmsm_record_random": {"envs": N_ENVS, "steps": T_RECORD, "ms": rec_ms,
                                 "bytes_written": rec_bytes,
                                 "env_steps_per_s": N_ENVS * T_RECORD / (rec_ms / 1e3),
                                 "GB_per_s": rec_bytes / (rec_ms / 1e3) / 1e9,
                                 "bound_ms": bound_ms(N_ENVS * T_RECORD, ops["pmsm_record_random"],
                                                      rec_nbytes)[0],
                                 "mean_reward_1024": short_r, "reset_share": rec_reset,
                                 **rec_design},
          "sync_record_random": {"envs": N_ENVS, "steps": T_RECORD, "ms": u_rec_ms,
                                 "ops_per_step": ops["sync_record_random/Finite-CC-PMSM-v0"],
                                 "reset_share": u_rec_reset},
          "specialised_over_universal": rec_ms / u_rec_ms,
          "checks": checks, "launches": launches})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"output checks failed: {failed}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # ---- 6. kernels line -------------------------------------------------
    main_shape = {"pmsm_rollout_random": (T_ROLLOUT, roll_ms, roll_bytes),
                  "pmsm_record_random": (T_RECORD, rec_ms, rec_nbytes)}
    main_design = {"pmsm_rollout_random": roll_design, "pmsm_record_random": rec_design}
    line = []
    for name in fs.KERNELS:
        r = results[name]
        row = {"name": name, "route": "cuda", "source": "gym_electric_motor_tpu_torch/csrc/fused_pmsm.cu",
               "replaces": {"pmsm_rollout_random": "gym_electric_motor_tpu/ops/pallas_sync.py:280",
                            "pmsm_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_sync.py:297",
                            "pmsm_record_random": "gym_electric_motor_tpu/ops/pallas_sync.py:502",
                            "pmsm_record_buffer": "gym_electric_motor_tpu/ops/pallas_sync.py:392"}[name],
               "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": None, "envs": N_ENVS, "steps": r["compare_steps"],
               "match_share": r["match_share"]}
        if name in main_shape:
            steps, ms, nbytes = main_shape[name]
            row["main_steps"], row["main_ms"] = steps, ms
            row["main_bound_ms"] = bound_ms(N_ENVS * steps, ops[name], nbytes)[0]
        if name in main_design:
            row.update({"main_" + k: main_design[name][k] for k in (
                "design", "ring", "registers", "issue_bound_ms", "issue_floor_ms")
                if k in main_design[name]})
        if name == "pmsm_record_random":
            row.update(universal="sync_record_random", universal_ms=u_rec_ms,
                       specialised_over_universal=rec_ms / u_rec_ms)
        line.append(row)
    return line, ops


def rl_weights(torch, rng, dev, n_features, hidden, scale, bias_scale):
    """Flat (w1, b1, w2, b2) drawn from numpy: N(0, scale^2) weights and
    N(0, bias_scale^2) biases."""
    import numpy as np

    sizes = (n_features * hidden, hidden, hidden * 8, 8)
    return [torch.as_tensor((rng.normal(size=n) * (bias_scale if j % 2 else scale))
                            .astype(np.float32), device=dev) for j, n in enumerate(sizes)]


# the mangled prefix of policy_record's instance at H 32 by lanes an env
# (ptxas registers)
RECORD_INSTANCES = {1: "policy_record_kernelILi32E",
                    8: "policy_record_lanes_kernelILi32ELi8ELb1E",
                    4: "policy_record_lanes_kernelILi32ELi4ELb0E"}


def record_fields(fp, n, env_steps, nbytes, ms):
    """policy_record's launch over ``n`` envs (csrc/fused_policy.cu): its
    design, lanes, blocks and registers and, on lane groups, the issue bound
    of G lanes' counts (``lane_fields``; eight lanes step on lane 0 alone, a
    branch on the lane that every warp issues)."""
    from gym_electric_motor_tpu_torch.ops import cuda_build

    lay = fp.policy_record_layout(n)
    regs = ptxas_registers(cuda_build.BUILD_LOG.get("fused_policy", ""))
    out = {"design": lay["design"], "lanes": lay["lanes"], "blocks": lay["blocks"],
           "sms": lay["sms"], "registers": next((r for f, r in regs.items()
                                                 if RECORD_INSTANCES[lay["lanes"]] in f), None)}
    if lay["lanes"] > 1:
        out.update(lane_fields("policy_record/8" if lay["lanes"] == 8 else "policy_record",
                               env_steps, nbytes, ms))
    return out


def policy_rollout_fields(fp, sample, ref_mode, env_steps, nbytes, ms):
    """policy_rollout's launch at H 16 in these modes (csrc/fused_policy.cu,
    ``ring_fields``; categorical with Wiener references, or greedy with
    constant ones, the instances tools/sass_ops.py counts): with Wiener
    references the ring, the registers and both roles' issue bound; with
    constant ones one thread per env reading the weights as 16-byte vectors.
    The bound stays the one-thread step's with its weights read one at a
    time, the function's own work."""
    layout = fp.policy_rollout_layout(H_EVAL, sample, ref_mode)
    regs = {role: layout.pop(f"{role}_registers") for role in ("consumer", "producer")}
    one_key = "policy_rollout" + ("" if ref_mode == "wiener" else f"/{sample}/const")
    if layout["design"] == DESIGNS[0]:
        regs["launch"] = WS_KERNELS["policy_rollout_ws"]["registers"]
    return ring_fields(layout, "policy_rollout_ws", one_key + "/vec", one_key, env_steps,
                       nbytes, ms, regs)


def reinforce_fields(fp, env_steps, nbytes, ms):
    """reinforce_rollout's launch at H 16 (csrc/reinforce_split.cuh): its
    layout (fused_policy.reinforce_layout: step and trace warps, ring,
    shared memory, setmaxnreg budgets), its registers (ptxas), both roles'
    counts, the issue bound of the step warp's count plus T trace warps'
    per env-step, every pipe included, and the issue-slot floor of the same
    instructions, each with its share.  The row's bound_ms stays the
    one-thread step's FP32 and XU work (BOUND_PIPES), repeated here as
    one_thread_bound_ms."""
    layout = fp.reinforce_layout(H_EVAL, env_steps // T_REINFORCE)
    info = WS_KERNELS["reinforce_split"]
    one = {k: v for k, v in OPS["reinforce_rollout"].items()
           if k in BOUND_PIPES["reinforce_rollout"]}
    i_ms = bound_ms(env_steps, info["ops"], nbytes, list(info["ops"]))[0]
    return {"design": layout.pop("design"), "layout": layout, "registers": info["registers"],
            "role_ops": info["roles"], "one_thread_bound_ms": bound_ms(env_steps, one, nbytes)[0],
            "ops_per_env_step": info["ops"], "issue_bound_ms": i_ms, "issue_bound_share": i_ms / ms,
            **floor_fields(env_steps, INSNS["reinforce_split"], ms)}


def run_rl(dev, card, ops):
    """Slice 2, RL on Finite-CC-PMSM-v0: the policy kernels against their
    plain versions, the greedy kernel against the env, REINFORCE against
    autograd, then the RL main path (fused-collection PPO at full width,
    the REINFORCE trainer, evaluation rollouts) with its launch counts and
    timings.  Returns the policy kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.parallel import (init_actor_critic_params,
                                                       make_fused_ppo_trainer, policy_obs)
    from gym_electric_motor_tpu_torch.parallel import sharded as tsh

    R = N_ENVS // 128
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=SF)
    consts = fp.PolicyConsts(env)
    rng = np.random.default_rng(SEED)
    i_sd0 = torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
    i_sq0 = torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
    eps0 = torch.as_tensor(rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32), device=dev)
    ref_d = torch.as_tensor(rng.uniform(-0.5, 0.5, (R, 128)).astype(np.float32), device=dev)
    ref_q = torch.as_tensor(rng.uniform(-0.5, 0.5, (R, 128)).astype(np.float32), device=dev)
    w16 = rl_weights(torch, rng, dev, 6, H_EVAL, 0.5, 0.1)
    w32 = rl_weights(torch, rng, dev, 7, H_PPO, 0.5, 0.1)
    start = (i_sd0, i_sq0, eps0)
    state_bytes = 3 * 4 * N_ENVS

    def wbytes(n_features, hidden):
        return 4 * fp.n_policy_params(n_features, hidden)

    # ---- 7. policy kernels against their plain versions ------------------
    results = {}

    def random_check(name, got, ref, is_angle, r_idx):
        share, worst = env_match(torch, got, ref, is_angle, N_ENVS)
        mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
        rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
        row = dict(match_share=share, max_abs_err=worst, mean_reward=mean_k,
                   mean_reward_plain=mean_p, mean_reward_rel_err=rel)
        if share < 0.999 or rel > 1e-4:
            emit({"phase": "policy_kernels", "name": name, **row})
            raise AssertionError(f"{name}: {share:.5f} of envs match (need 0.999), "
                                 f"mean reward rel err {rel:.2e} (need 1e-4)")
        return row

    def block_err(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    # policy_rollout: greedy/const and categorical/Wiener (timed) at H 16,
    # then every other instance (H 8, 16, 32 x categorical/greedy x
    # Wiener/const) at T_POLICY_BIT steps, each bit for bit (error 0 in
    # every env; csrc/fused_policy.cu, a ring with Wiener references)
    args_g = (consts, SEED, *w16, *start, ref_d, ref_q, T_COMPARE, "greedy", "const")
    got, ref = fp.policy_rollout(*args_g), fp.policy_rollout_plain(*args_g)
    err_g = check_buffer(torch, "policy_rollout greedy/const", got, ref,
                         (False, False, True, False, False))
    instances = {"H16/greedy/const": bit_match(torch, got, ref, N_ENVS)}
    args_c = (consts, SEED, *w16, *start, None, None, T_COMPARE)
    ms, got = cuda_ms(torch, lambda: fp.policy_rollout(*args_c), reps=21)
    plain_ms, ref = host_ms(torch, lambda: fp.policy_rollout_plain(*args_c))
    row = random_check("policy_rollout", got, ref, (False, False, True, False, False), 3)
    instances["H16/categorical/wiener"] = bit_match(torch, got, ref, N_ENVS)
    rng_bit = np.random.default_rng(SEED + 1)
    for hidden in fp.HIDDEN_SIZES:
        w_h = rl_weights(torch, rng_bit, dev, 6, hidden, 0.5, 0.1)
        for sample in ("categorical", "greedy"):
            for ref_mode in ("wiener", "const"):
                label = f"H{hidden}/{sample}/{ref_mode}"
                if label in instances:
                    continue
                args_i = (consts, SEED, *w_h, *start, ref_d, ref_q, T_POLICY_BIT, sample, ref_mode)
                instances[label] = bit_match(torch, fp.policy_rollout(*args_i),
                                             fp.policy_rollout_plain(*args_i), N_ENVS)
    unequal = {k: v for k, v in instances.items() if v != (1.0, 0.0)}
    if unequal:
        raise AssertionError(f"policy_rollout differs from its plain version (share of envs "
                             f"equal, max abs err): {unequal}")
    row["max_abs_err"] = max(row["max_abs_err"], err_g)
    p_bytes = state_bytes + 5 * 4 * N_ENVS + wbytes(6, H_EVAL)
    row.update(ms=ms, plain_ms=plain_ms, max_abs_err_greedy_const=err_g, steps=T_COMPARE,
               bit_equal_instances=sorted(instances), bit_steps=T_POLICY_BIT,
               bound=bound_ms(N_ENVS * T_COMPARE, ops["policy_rollout"], p_bytes),
               **policy_rollout_fields(fp, "categorical", "wiener", N_ENVS * T_COMPARE, p_bytes,
                                       ms))
    results["policy_rollout"] = row

    # policy_record at H 32, bit for bit (error 0 in every env), at 16384
    # envs (one thread per env), at PPO's 2048 (eight lanes an env) and at
    # 4096 (four lanes), each timed (csrc/fused_policy.cu)
    args_r = (consts, SEED, *w32, *start, T_COMPARE)
    ms, got = cuda_ms(torch, lambda: fp.policy_record(*args_r), reps=21)
    plain_ms, ref = host_ms(torch, lambda: fp.policy_record_plain(*args_r))
    row = random_check("policy_record", got, ref, (False, False, True) + (False,) * 5, 6)
    widths = {}
    for n in (N_ENVS, PPO["n_envs"], 2 * PPO["n_envs"]):
        if n == N_ENVS:
            T, ms_n = T_COMPARE, ms
        else:
            T = PPO["horizon"]
            args_n = (consts, SEED, *w32, *(x[:n // 128] for x in start), T)
            ms_n, got = cuda_ms(torch, lambda: fp.policy_record(*args_n), reps=21)
            ref = fp.policy_record_plain(*args_n)
        m, err = bit_match(torch, got, ref, n)
        del got, ref
        if m != 1.0:
            raise AssertionError(f"policy_record at {n} envs: {m:.5f} of envs equal their plain "
                                 f"version bit for bit (need 1), max abs err {err}")
        nbytes = 12 * n + 32 * n * T + wbytes(7, H_PPO)
        b_ms, b_by = bound_ms(n * T, ops["policy_record"], nbytes)
        widths[f"{n}x{T}"] = {"ms": ms_n, "match_share": m, "max_abs_err": err, "bound_ms": b_ms,
                              "bound_by": b_by, **record_fields(fp, n, n * T, nbytes, ms_n)}
    row.update(ms=ms, plain_ms=plain_ms, steps=T_COMPARE, widths=widths,
               bound=bound_ms(N_ENVS * T_COMPARE, ops["policy_record"],
                              state_bytes + 32 * N_ENVS * T_COMPARE + wbytes(7, H_PPO)))
    results["policy_record"] = row

    # reinforce_rollout (+ reinforce_reduce): greedy/const, then categorical/
    # Wiener at the trainer's shape (phase 10: T_REINFORCE steps, gamma 0.99)
    n_p = fp.n_policy_params(6, H_EVAL)
    args_g = (consts, SEED, -0.05, *w16, *start, ref_d, ref_q, T_COMPARE, 0.97, "greedy", "const")
    got, ref = fp.reinforce_rollout(*args_g), fp.reinforce_rollout_plain(*args_g)
    err_g = check_buffer(torch, "reinforce_rollout greedy/const", got[:5], ref[:5],
                         (False, False, True, False, False))
    blk_g = block_err(got[5], ref[5])
    if not blk_g < 1e-4:
        raise AssertionError(f"reinforce greedy/const gradient block off by {blk_g:.2e} of its max")
    args_c = (consts, SEED, -0.1, *w16, *start, None, None, T_REINFORCE, 0.99)
    ms, got = cuda_ms(torch, lambda: fp.reinforce_rollout(*args_c), reps=21)
    plain_ms, ref = host_ms(torch, lambda: fp.reinforce_rollout_plain(*args_c))
    blk_c = block_err(got[5], ref[5])
    row = random_check("reinforce_rollout", got[:5], ref[:5], (False, False, True, False, False), 3)
    if not blk_c < 1e-4:
        raise AssertionError(f"reinforce categorical/Wiener block off by {blk_c:.2e} of its max "
                             f"({row['match_share']:.5f} of envs match)")
    rein_bytes = state_bytes + 5 * 4 * N_ENVS + wbytes(6, H_EVAL) + 4 * n_p * N_ENVS
    rein_ops = {k: v for k, v in ops["reinforce_rollout"].items()
                if k in BOUND_PIPES["reinforce_rollout"]}
    row.update(ms=ms, plain_ms=plain_ms, max_abs_err=max(row["max_abs_err"], err_g),
               grad_block_rel_err_greedy_const=blk_g, grad_block_rel_err=blk_c, steps=T_REINFORCE,
               bound=bound_ms(N_ENVS * T_REINFORCE, rein_ops, rein_bytes),
               bound_ms_all_pipes=bound_ms(N_ENVS * T_REINFORCE, ops["reinforce_rollout"],
                                           rein_bytes)[0],
               **reinforce_fields(fp, N_ENVS * T_REINFORCE, rein_bytes, ms))
    results["reinforce_rollout"] = row
    rein_finite = all(bool(torch.isfinite(x).all()) for x in got)
    rein_mean = float(got[3].double().sum()) / (N_ENVS * T_REINFORCE)
    del got, ref

    # reinforce_reduce alone, on per-env sums from numpy
    acc = torch.as_tensor(rng.normal(size=(n_p, N_ENVS)).astype(np.float32), device=dev)
    ms, got = cuda_ms(torch, lambda: fp.reinforce_reduce(acc), reps=21)
    plain_ms, ref = host_ms(torch, lambda: fp.reinforce_reduce_plain(acc))
    red_err = float((got - ref).abs().max())
    if red_err != 0.0:
        raise AssertionError(f"reinforce_reduce differs from its plain version by {red_err:.3e}")
    results["reinforce_reduce"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=red_err, match_share=1.0, steps=None,
        bound=bound_ms(n_p * 128 * (R - 1), ops["reinforce_reduce"], 4 * n_p * (N_ENVS + 128)))
    for name in fp.KERNELS:
        r = results[name]
        emit({"phase": "policy_kernels", "name": name, "envs": N_ENVS,
              **{k: v for k, v in r.items() if k != "bound"}, "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1]})

    # ---- 8. checks on the RL entry points (their launches are not counted)
    # The greedy policy kernel against the env under the MLP's argmax,
    # and the REINFORCE gradient against autograd on that trajectory.  Every
    # env starts from the env's reset state with the same constant
    # references (tests/test_pallas_rollout.py:439-479, 565-609).
    env_c = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=SF,
                               reference_generator=rg.ReferenceSpec(
                                   [rg.ConstReference("i_sd", -0.1), rg.ConstReference("i_sq", 0.2)]))
    w_eval = rl_weights(torch, rng, dev, 6, H_EVAL, 0.1, 0.0)  # init_policy_params' scale
    policy = tsh.Policy(w_eval[0].reshape(6, H_EVAL).clone(), w_eval[1].clone(),
                        w_eval[2].reshape(H_EVAL, 8).clone(), w_eval[3].clone())
    venv = gt.VectorEnv(env_c, N_ENVS)
    state, _obs = venv.reset(SEED)
    obs_l, act_l, rew_l = [], [], []
    with torch.no_grad():
        for _ in range(T_RL_ENV):
            o = policy_obs(env_c, state)
            a = torch.argmax(policy(o), dim=-1)
            state, _obs, r, _term = venv.step(state, a)
            obs_l.append(o), act_l.append(a), rew_l.append(r)
    obs_t, act_t, rew_t = torch.stack(obs_l), torch.stack(act_l), torch.stack(rew_l)
    z = torch.zeros((R, 128), device=dev)
    rd, rq = torch.full_like(z, -0.1), torch.full_like(z, 0.2)
    k_out = fp.make_fused_policy_rollout(env_c, T_RL_ENV, N_ENVS, hidden=H_EVAL, sample="greedy",
                                         ref_mode="const")(SEED, *w_eval, z, z, z, rd, rq)
    ode = state.phys.ode_state
    err_env = check_buffer(torch, "env vs policy_rollout greedy/const", k_out[:2],
                           [ode[:, 1].reshape(R, 128), ode[:, 2].reshape(R, 128)], (False, False))
    mean_env = float(rew_t.double().mean())
    mean_k = float(k_out[3].double().sum()) / (N_ENVS * T_RL_ENV)
    if abs(mean_k - mean_env) > 1e-5 * abs(mean_env) + 1e-7:
        raise AssertionError(f"env vs policy_rollout: mean reward {mean_k} against {mean_env}")
    if bool((rew_t < -5).any()):
        raise AssertionError("the greedy constant-reference run violated a constraint")

    oracle = {}
    for gamma in (0.0, 0.97):
        out = fp.make_fused_reinforce_rollout(env_c, T_RL_ENV, N_ENVS, hidden=H_EVAL, gamma=gamma,
                                              sample="greedy", ref_mode="const")(
            SEED, -0.07, *w_eval, z, z, z, rd, rq)
        g_kernel = fp.unflatten_policy_grads(out[5], 6, 8, H_EVAL)
        adv = rew_t.double() + 0.07
        wts = torch.zeros_like(adv)
        acc_t = torch.zeros_like(adv[0])
        for t in range(T_RL_ENV - 1, -1, -1):
            acc_t = adv[t] + gamma * acc_t
            wts[t] = acc_t
        policy.zero_grad()
        logp = torch.log_softmax(policy(obs_t.reshape(-1, 6)), dim=-1)
        surrogate = torch.sum(wts.float().reshape(-1) * logp[torch.arange(logp.shape[0], device=dev),
                                                             act_t.reshape(-1)])
        surrogate.backward()
        rel = {k: float((g_kernel[k] - getattr(policy, k).grad).abs().max()
                        / (getattr(policy, k).grad.abs().max() + 1e-9)) for k in g_kernel}
        oracle[str(gamma)] = rel
        if max(rel.values()) >= 1e-4:
            raise AssertionError(f"REINFORCE gradient at gamma {gamma} vs autograd: {rel}")
    emit({"phase": "rl_checks", "envs": N_ENVS, "steps": T_RL_ENV,
          "env_vs_policy_rollout_max_abs_err": err_env, "mean_reward_env": mean_env,
          "mean_reward_kernel": mean_k, "reinforce_vs_autograd_rel_err": oracle})
    del obs_t, act_t, rew_t, obs_l, state, venv

    # ---- 9.-11. the RL main paths, each counted from zero ----------------
    by_path = {}

    def path_launches(path, expect):
        """Reads the launches since the last reset, which must be ``expect``."""
        got = {k: v for k, v in fp.LAUNCHES.items() if v}
        by_path[path] = got
        if got != expect:
            raise AssertionError(f"RL path {path}: kernel launches {got}, expected {expect}")

    # 9. fused-collection PPO at full width
    fp.reset_launches()
    init_opt, train = make_fused_ppo_trainer(env, **PPO)
    model = init_actor_critic_params(SEED, 7, 8, H_PPO, device=dev)
    p0 = [p.detach().clone() for p in model.parameters()]
    opt = init_opt(model)
    ne = PPO["n_envs"]
    planes = tuple(torch.zeros((ne // 128, 128), device=dev) for _ in range(3))
    model, opt, planes, rs_warm = train(model, opt, planes, 3, PPO_WARMUP)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(PPO_ITERS)]
    rs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (e0, e1, e2) in enumerate(events):
        e0.record()
        out = train.collect(model, planes, 3 + PPO_WARMUP + i)
        e1.record()
        planes, mean_r = train.ppo_update(model, opt, out, planes, 3 + PPO_WARMUP + i)
        e2.record()
        rs.append(mean_r)
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t0
    path_launches("ppo", {"policy_record": PPO_WARMUP + PPO_ITERS})
    rs = torch.stack(rs).double().cpu().numpy()
    collect_ms = [e0.elapsed_time(e1) for e0, e1, _ in events]
    update_ms = [e1.elapsed_time(e2) for _, e1, e2 in events]
    moved = all(not torch.equal(p.detach(), q) for p, q in zip(model.parameters(), p0))
    # the alignment invariant on one recorded batch at this width
    out = train.collect(model, planes, 999)
    obs_b, act_b, logp_b, _adv, _ret = tsh.ppo_batch(model, train.roll, out, planes, PPO["gamma"],
                                                     0.95)
    with torch.no_grad():
        _lp, ent_b = tsh.heads_logp_ent(model(obs_b)[0], act_b, train.roll.act_ns)
    align = float(logp_b.double().mean() + ent_b.double().mean())
    ppo = {"envs": ne, "horizon": PPO["horizon"], "hidden": H_PPO, "iters": PPO_ITERS,
           "seconds": ppo_s, "env_steps_per_s": PPO_ITERS * ne * PPO["horizon"] / ppo_s,
           "collect_ms_median": float(np.median(collect_ms)),
           "update_ms_median": float(np.median(update_ms)),
           "iter_ms_host": 1e3 * ppo_s / PPO_ITERS, "mean_reward_first": float(rs[0]),
           "mean_reward_last": float(rs[-1]), "mean_reward": float(rs.mean()),
           "params_moved": moved, "alignment": align}
    emit({"phase": "ppo", "card": card, **ppo})
    if not (np.isfinite(rs).all() and -0.5 < rs.min() and rs.max() < 0.0):
        raise AssertionError(f"PPO rewards out of (-0.5, 0): {rs}")
    if not moved:
        raise AssertionError("PPO left a parameter unchanged")
    if not abs(align) < 0.02:
        raise AssertionError(f"PPO alignment |E[log pi] + E[H]| = {abs(align):.4f} (need < 0.02)")
    del out, obs_b, act_b, logp_b

    # 10. timings: evaluation rollout and REINFORCE trainer (the REINFORCE
    # rollout was timed at the trainer's shape in phase 7)
    fp.reset_launches()
    roll = fp.make_fused_policy_rollout(env, T_POLICY, N_ENVS, hidden=H_EVAL)
    pol_ms, pol = cuda_ms(torch, lambda: roll(SEED, *w16, z, z, z), reps=EVAL_REPS)
    # greedy with constant (zero) references: the one-thread kernel's
    # vectorised weight reads alone, without the ring
    roll_g = fp.make_fused_policy_rollout(env, T_POLICY, N_ENVS, hidden=H_EVAL, sample="greedy",
                                          ref_mode="const")
    pol_g_ms, pol_g = cuda_ms(torch, lambda: roll_g(SEED, *w16, z, z, z, z, z), reps=EVAL_REPS)
    # cuda_ms warms up twice
    path_launches("evaluation", {"policy_rollout": 2 * (2 + EVAL_REPS)})
    pol_mean = float(pol[3].double().sum()) / (N_ENVS * T_POLICY)
    pol_g_mean = float(pol_g[3].double().sum()) / (N_ENVS * T_POLICY)
    checks = {"finite": all(bool(torch.isfinite(x).all()) for x in pol + pol_g),
              "eps_in_range": all(bool(((x[2] >= 0) & (x[2] < 2 * math.pi)).all())
                                  for x in (pol, pol_g)),
              "reward_scale": -0.5 < pol_mean < 0.0 and pol_g_mean < 0.0}
    main_bytes = state_bytes + 20 * N_ENVS + wbytes(6, H_EVAL)
    eval_rows = {
        "categorical/wiener": (pol_ms, pol_mean, pol, policy_rollout_fields(
            fp, "categorical", "wiener", N_ENVS * T_POLICY, main_bytes, pol_ms)),
        "greedy/const": (pol_g_ms, pol_g_mean, pol_g, policy_rollout_fields(
            fp, "greedy", "const", N_ENVS * T_POLICY, main_bytes + 8 * N_ENVS, pol_g_ms))}
    checks["reinforce_finite"] = rein_finite
    t_rein, rein_ms = T_REINFORCE, results["reinforce_rollout"]["ms"]
    trainer = fp.make_fused_reinforce_trainer(env, t_rein, N_ENVS, hidden=H_EVAL, gamma=0.99)
    rpol = tsh.Policy(w16[0].reshape(6, H_EVAL).clone(), w16[1].clone(),
                      w16[2].reshape(H_EVAL, 8).clone(), w16[3].clone())
    fp.reset_launches()
    train_ms, (rpol, rrs) = host_ms(torch, lambda: trainer(SEED, rpol, REINFORCE_ITERS))
    path_launches("reinforce_trainer", {"reinforce_rollout": REINFORCE_ITERS,
                                        "reinforce_reduce": REINFORCE_ITERS})
    rrs = rrs.double().cpu().numpy()
    checks["reinforce_trainer"] = bool(np.isfinite(rrs).all() and (-0.5 < rrs).all()
                                       and (rrs < 0).all()
                                       and all(bool(torch.isfinite(p).all())
                                               for p in rpol.parameters()))

    # 11. PPO learns: 1200 iterations at full width (tools/torch_ppo_learn.py)
    import torch_ppo_learn

    fp.reset_launches()
    learned = torch_ppo_learn.learn(dev, LEARN_ITERS, 3, log=lambda d: None)
    path_launches("ppo_learn", {"policy_record": LEARN_ITERS})
    emit({"phase": "ppo_learn", "card": card, **learned})
    if not learned["ok"]:
        raise AssertionError(f"PPO did not learn: {learned}")
    launches = {k: sum(p.get(k, 0) for p in by_path.values()) for k in fp.KERNELS}
    emit({"phase": "rl_timings", "card": card,
          "policy_rollout": {
              mode: {"envs": N_ENVS, "steps": T_POLICY, "hidden": H_EVAL, "ms": m,
                     "env_steps_per_s": N_ENVS * T_POLICY / (m / 1e3), "mean_reward": r,
                     "reset_share": float(o[4].double().sum()) / (N_ENVS * T_POLICY), **f}
              for mode, (m, r, o, f) in eval_rows.items()},
          "reinforce_rollout": {"envs": N_ENVS, "steps": t_rein, "hidden": H_EVAL, "ms": rein_ms,
                                "env_steps_per_s": N_ENVS * t_rein / (rein_ms / 1e3),
                                "mean_reward": rein_mean},
          "reinforce_trainer": {"envs": N_ENVS, "steps": t_rein, "iters": REINFORCE_ITERS,
                                "ms": train_ms,
                                "env_steps_per_s": REINFORCE_ITERS * N_ENVS * t_rein / (train_ms / 1e3),
                                "mean_reward": rrs.tolist()},
          "checks": checks, "launches": launches, "launches_by_path": by_path})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"RL output checks failed: {failed}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the RL main paths: {missing}")

    # ---- kernels line rows (REINFORCE's compare shape is its main shape) --
    main = {
        "policy_rollout": (N_ENVS, T_POLICY, pol_ms, bound_ms(
            N_ENVS * T_POLICY, ops["policy_rollout"], main_bytes)),
        "policy_record": (ne, PPO["horizon"], float(np.median(collect_ms)), bound_ms(
            ne * PPO["horizon"], ops["policy_record"],
            12 * ne + 32 * ne * PPO["horizon"] + wbytes(7, H_PPO))),
    }
    replaces = {"policy_rollout": "gym_electric_motor_tpu/ops/pallas_policy.py:268",
                "policy_record": "gym_electric_motor_tpu/ops/pallas_policy.py:477",
                "reinforce_rollout": "gym_electric_motor_tpu/ops/pallas_policy.py:747",
                "reinforce_reduce": "gym_electric_motor_tpu/ops/pallas_policy.py:747"}
    line = []
    for name in fp.KERNELS:
        r = results[name]
        row = {"name": name, "route": "cuda",
               "source": "gym_electric_motor_tpu_torch/csrc/fused_policy.cu",
               "replaces": replaces[name], "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None,
               "envs": N_ENVS, "steps": r["steps"], "match_share": r["match_share"],
               "launches_by_path": {p: c[name] for p, c in by_path.items() if name in c}}
        if "bound_ms_all_pipes" in r:
            row["bound_ms_all_pipes"] = r["bound_ms_all_pipes"]
        if name in main:
            envs, steps, ms, (b_ms, b_by) = main[name]
            row.update(main_envs=envs, main_steps=steps, main_ms=ms, main_bound_ms=b_ms,
                       main_bound_by=b_by)
        if name == "policy_rollout":
            row.update({"main_" + k: v for k, v in eval_rows["categorical/wiener"][3].items()})
            row["main_ms_greedy_const"] = pol_g_ms
        if name == "policy_record":
            row.update({"main_" + k: v for k, v in record_fields(
                fp, ne, ne * PPO["horizon"], 12 * ne + 32 * ne * PPO["horizon"] + wbytes(7, H_PPO),
                main[name][2]).items()})
        line.append(row)
    return line


def held_random(torch, label, name, got, ref, angle, worst, share):
    """The random-mode rule on a family kernel's and its plain version's
    outputs (``angle``: which outputs are angles): at least 99.9% of envs
    match and the mean reward agrees to 1e-4 relative.  Keeps the worst
    error and the least share per kernel in ``worst`` and ``share``;
    returns the row entry, raises on failure."""
    # the reward sums follow the states (rollout), the reward precedes done
    # (recorder)
    r_idx = len(got) - 6 if name.endswith("_rollout_random") else len(got) - 2
    m, err = env_match(torch, got, ref, angle, N_ENVS)
    mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
    rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
    share[name] = min(share[name], m)
    worst[name] = max(worst[name], err)
    if m < 0.999 or rel > 1e-4:
        raise AssertionError(f"{label} {name}: {m:.5f} of envs match (need 0.999), "
                             f"mean reward rel err {rel:.2e} (need 1e-4), max abs err {err}")
    return {"max_abs_err": err, "match_share": m, "mean_reward": mean_k,
            "mean_reward_rel_err": rel}


def hold_bit_equal(torch, gt, rg, dev, fam, ids, refs_of, worst, share, modes=("rollout",)):
    """The random kernels ``<fam.prefix>_<mode>_random`` of ``modes`` (the
    warp-specialised rollout; the recorder too where it runs on a ring)
    against their plain versions bit for bit: compare_family_kernels' runs
    (the catalog's Wiener references on every id, and the deep runs) must
    have found error 0 in every env, and each kernel runs again on every id
    with the constant references ``refs_of(env_id)`` (the loop without the
    reference advance), every output equal, or NaN in both.  Emits one line
    per kernel; raises otherwise."""
    names = [f"{fam.prefix}_{mode}_random" for mode in modes]
    for name in names:
        if worst[name] != 0.0 or share[name] != 1.0:
            raise AssertionError(f"{name}: max abs err {worst[name]}, {share[name]} of envs "
                                 "match (need 0 and 1)")
    for env_id in ids:
        env = gt.make_functional(env_id, device=dev, reference_generator=rg.ReferenceSpec(
            [rg.ConstReference(n, v) for n, v in refs_of(env_id)]))
        c = fam.consts(env)
        if not c.all_const:
            raise AssertionError(f"{env_id}: the constant references did not make all_const")
        start = fam.planes(c)
        for name in names:
            got = getattr(fam.mod, name)(c, SEED, start, T_SYNC_COMPARE)
            torch.cuda.synchronize()
            ref = getattr(fam.mod, name + "_plain")(c, SEED, start, T_SYNC_COMPARE)
            for j, (x, y) in enumerate(zip(got, ref)):
                same = (x == y) | (torch.isnan(x) & torch.isnan(y))
                if not bool(same.all()):
                    raise AssertionError(f"{env_id} {name}, constant references: output {j} "
                                         f"differs in {int((~same).sum())} elements")
            del got, ref
    for name in names:
        emit({"phase": f"{fam.prefix}_kernels_bit_equal", "kernel": name, "ids": len(ids),
              "wiener": {"max_abs_err": worst[name], "match_share": share[name]},
              "const": {"envs": N_ENVS, "steps": T_SYNC_COMPARE, "max_abs_err": 0.0,
                        "match_share": 1.0}})


def compare_family_kernels(torch, gt, dev, fam, ids, timed_id, deep_ids, ops, env_kw=None):
    """A universal family's four kernels (``fam.mod``, named
    ``<fam.prefix>_<mode>``) against their plain versions on every id of
    ``ids`` at T_SYNC_COMPARE steps, timed with their bounds on
    ``timed_id``; the two random kernels again at the recorder's main-path
    depth on ``deep_ids``, where drift between kernel and plain version
    would show.  ``env_kw`` (keyword arguments of ``make_functional``, such
    as a motor override) applies to every env.  Emits one line per id and
    one for the deep runs; returns ``(worst, share, timed)`` per kernel."""
    mod, N = fam.mod, N_ENVS
    worst = dict.fromkeys(mod.KERNELS, 0.0)
    share = dict.fromkeys(mod.KERNELS, 1.0)
    timed = {}
    env_kw = env_kw or {}
    for env_id in ids:
        c = fam.consts(gt.make_functional(env_id, device=dev, **env_kw))
        start, acts = fam.planes(c), fam.actions(c, T_SYNC_COMPARE)
        row = {"phase": f"{fam.prefix}_kernels", "env_id": env_id, "envs": N,
               "steps": T_SYNC_COMPARE}
        if env_kw:
            row["env_kw"] = env_kw
        for mode in ("rollout_buffer", "record_buffer", "rollout_random", "record_random"):
            name = f"{fam.prefix}_{mode}"
            kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
            args = (start, acts) if mode.endswith("buffer") else (SEED, start, T_SYNC_COMPARE)
            if env_id == timed_id:
                ms, got = cuda_ms(torch, lambda: kern(c, *args), reps=21)
                plain_ms, ref = host_ms(torch, lambda: plain(c, *args))
                b_ms, b_by = bound_ms(N * T_SYNC_COMPARE, ops[name],
                                      fam.nbytes(c, name, N, T_SYNC_COMPARE))
                timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            else:
                got = kern(c, *args)
                torch.cuda.synchronize()
                ref = plain(c, *args)
            angle = fam.angle(c, len(got))
            if mode.endswith("buffer"):
                err = check_buffer(torch, f"{env_id} {name}", got, ref, angle)
                worst[name] = max(worst[name], err)
                row[name] = {"max_abs_err": err}
            else:
                row[name] = held_random(torch, env_id, name, got, ref, angle, worst, share)
            del got, ref
        emit(row)
    deep = {}
    for env_id in deep_ids:
        c = fam.consts(gt.make_functional(env_id, device=dev, **env_kw))
        start = fam.planes(c)
        for mode in ("rollout_random", "record_random"):
            name = f"{fam.prefix}_{mode}"
            got = getattr(mod, name)(c, SEED, start, T_RECORD)
            torch.cuda.synchronize()
            ref = getattr(mod, name + "_plain")(c, SEED, start, T_RECORD)
            deep[f"{env_id} {name}"] = held_random(torch, env_id, name, got, ref,
                                                   fam.angle(c, len(got)), worst, share)
            del got, ref
    if deep_ids:
        emit({"phase": f"{fam.prefix}_kernels_deep", "envs": N, "steps": T_RECORD,
              "results": deep})
    return worst, share, timed


def env_vs_buffer_kernels(torch, gt, rg, fr, frec, dev, fam, env_id, refs, atol):
    """The port's env (VectorEnv's reset, the env's step without autoreset,
    constant references ``refs``, an action buffer, T_SYNC_ENV steps)
    against both buffer kernels, reached through the dispatch and started
    where the env's reset put each env (``fam.cols(c)``: the kernel
    states' columns of the env's ode state).  Each element must lie within ``atol``
    + 1e-4 |x| (angles modulo 2 pi); returns the row entry."""
    N, R = N_ENVS, N_ENVS // 128
    env_c = gt.make_functional(env_id, device=dev, reference_generator=rg.ReferenceSpec(
        [rg.ConstReference(n, v) for n, v in refs]))
    c = fam.consts(env_c)
    venv = gt.VectorEnv(env_c, N)
    state, _obs = venv.reset(SEED)
    acts = fam.actions(c, T_SYNC_ENV)
    cols = fam.cols(c)
    start = [state.phys.ode_state[:, j].reshape(R, 128).contiguous() for j in cols]
    traj, n_viol = [], 0
    for t in range(T_SYNC_ENV):
        state, _obs, _r, term = env_c.step(state, fam.env_action(c, acts[t]))
        n_viol += int(term.sum())
        traj.append(state.phys.ode_state[:, cols])
    ode = torch.stack(traj)  # (T, N, n_state)
    k_final = fr.make_fused_rollout(env_c, T_SYNC_ENV, N, action_mode="buffer")(*start, acts)
    k_traj = frec.make_fused_record_rollout(env_c, T_SYNC_ENV, N, action_mode="buffer")(*start, acts)
    k_traj = [k_traj[name] for name in c.state_names]
    angle = fam.angle(c, c.n_state)
    errs = []
    for got, want in ((k_final, [ode[-1, :, j].reshape(R, 128) for j in range(c.n_state)]),
                      (k_traj, [ode[:, :, j].reshape(T_SYNC_ENV, R, 128)
                                for j in range(c.n_state)])):
        err = 0.0
        for j, (x, y) in enumerate(zip(got, want)):
            d = angle_err(torch, x, y) if angle[j] else (x - y).abs()
            bad = (d > atol + 1e-4 * y.abs()) | ~torch.isfinite(x)
            if bool(bad.any()):
                raise AssertionError(f"{env_id}: env vs buffer kernel, state {j} off in "
                                     f"{int(bad.sum())} elements (max {float(d.max()):.3e})")
            err = max(err, float(d.max()))
        errs.append(err)
    return {"max_abs_err_rollout": errs[0], "max_abs_err_record": errs[1],
            "violations_seen": n_viol}


def family_kernel_rows(fam, source, replaces, launches, worst, share, timed, timed_on, n_ids,
                       main):
    """A universal family's rows of the kernels line; ``main`` holds the
    main-path timing (steps, ms, bound_ms) of the two random kernels."""
    line = []
    for name in fam.mod.KERNELS:
        t = timed[name]
        row = {"name": name, "route": "cuda", "source": source(name),
               "replaces": replaces[name], "launches": launches[name],
               "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
               "envs": N_ENVS, "steps": T_SYNC_COMPARE, "timed_on": timed_on,
               "match_share": share[name], "ids_compared": n_ids}
        if name in main:
            m = main[name]
            row.update(main_steps=m["steps"], main_ms=m["ms"], main_bound_ms=m["bound_ms"])
        line.append(row)
    return line


def sync_bytes(c, kernel, n, steps):
    """Bytes a kernel on a B6 bridge (the sync, induction and EESM
    families) must move for ``n`` envs and ``steps`` steps: each input once,
    each output once (4 bytes per action channel and step).  ``kernel`` ends
    in its mode (``..._rollout_random``, ...)."""
    state = 4 * n * c.n_state
    act = 4 * c.n_act * n * steps
    if kernel.endswith("_rollout_random"):
        return state + 4 * n * (c.n_state + 2) + 16 * n * c.n_ref
    if kernel.endswith("_rollout_buffer"):
        return 2 * state + act
    if kernel.endswith("_record_random"):
        return state + 4 * n * steps * (c.n_state + c.n_ref + c.n_act + 2)
    return state + act + 4 * n * steps * c.n_state


def run_sync(dev, card, ops):
    """Slice 3, the universal synchronous family: the four kernels of
    csrc/fused_sync.cu against their plain versions on the 12 ids, then the
    main path (env against the buffer kernels, the dispatch, timings) with
    its launches counted from zero.  Returns the sync kernels' rows of the
    kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_record as frec
    from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)

    def planes(c, amp=100.0):
        out = [torch.as_tensor(rng.uniform(-amp, amp, (R, 128)).astype(np.float32), device=dev)
               for _ in range(c.n_state - 1)]
        return out + [torch.as_tensor(rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32),
                                      device=dev)]

    def actions(c, steps):
        if c.finite:
            return torch.as_tensor(rng.integers(0, 8, (steps, R, 128)).astype(np.int32), device=dev)
        return torch.as_tensor(rng.uniform(-1.0, 1.0, (steps, 3, R, 128)).astype(np.float32),
                               device=dev)

    # ---- 13. the four kernels against their plain versions, every id -----
    fam = SimpleNamespace(
        mod=sf, prefix="sync", consts=sf.SyncConsts, planes=planes, actions=actions,
        nbytes=sync_bytes, angle=lambda c, n: [j == c.n_state - 1 for j in range(n)],
        cols=lambda c: ([0] if c.mech else []) + [1, 2, 3],
        env_action=lambda c, a: a.reshape(N) if c.finite else a.reshape(3, N).T.contiguous())
    worst, share, timed = compare_family_kernels(torch, gt, dev, fam, gt.SYNC_ENV_IDS, SYNC_TIMED,
                                                 (SYNC_SPECIALISED, SYNC_TIMED), ops)
    # the warp-specialised random rollout and recorder, bit for bit on every id
    hold_bit_equal(torch, gt, rg, dev, fam, gt.SYNC_ENV_IDS,
                   lambda env_id: SYNC_CONST_REFS[env_id.split("-")[1]], worst, share,
                   ("rollout", "record"))

    # ---- 14.-16. the main path: counts from zero ---------------------------
    fs.reset_launches()
    fp.reset_launches()
    sf.reset_launches()
    dcf.reset_launches()

    # 14. the env against the buffer kernels, through the dispatch
    # (rtol 1e-4 / atol 1e-3, tests/test_pallas_sync_universal.py:75-77)
    env_rows = {env_id: env_vs_buffer_kernels(torch, gt, rg, fr, frec, dev, fam, env_id,
                                              SYNC_CONST_REFS[env_id.split("-")[1]], 1e-3)
                for env_id in gt.SYNC_ENV_IDS}
    emit({"phase": "sync_env", "envs": N, "steps": T_SYNC_ENV, "ids": env_rows})

    # 15. the dispatch: exactly one launch of each random kernel per id
    disp, checks = {}, {}
    sc_kernel_reward = None
    for env_id in gt.SYNC_ENV_IDS:
        env = gt.make_functional(env_id, device=dev)
        n_state = fr.fused_state_arity(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(n_state)]
        before = (dict(sf.LAUNCHES), dict(fs.LAUNCHES), dict(fp.LAUNCHES))
        roll = fr.make_fused_rollout(env, T_DISPATCH, N)(SEED, *z)
        rec = frec.make_fused_record_rollout(env, T_DISPATCH, N)(SEED, *z)
        torch.cuda.synchronize()
        delta = {k: v - before[0][k] for k, v in sf.LAUNCHES.items() if v != before[0][k]}
        others = (fs.LAUNCHES != before[1]) or (fp.LAUNCHES != before[2]) or any(dcf.LAUNCHES.values())
        if delta != {"sync_rollout_random": 1, "sync_record_random": 1} or others:
            raise AssertionError(f"{env_id}: the dispatch launched {delta} (other kernels: "
                                 f"{others}), expected one sync_rollout_random and one "
                                 "sync_record_random")
        c = sf.SyncConsts(env)
        eps = roll[n_state - 1]
        rv = roll[n_state + 2]
        lo = min(row["mlo"] for row in c.rows)
        hi = max(row["mhi"] for row in c.rows)
        ok = {
            "finite": all(bool(torch.isfinite(x).all()) for x in roll)
            and all(bool(torch.isfinite(x.float()).all()) for x in rec.values()),
            # [0, 2 pi] in float32: a tiny negative angle wraps to 2 pi exactly
            "eps_in_range": bool(((eps >= 0) & (eps <= float(np.float32(2 * math.pi)))).all()),
            "ref_in_margin": bool(((rv >= lo - 1e-6) & (rv <= hi + 1e-6)).all()),
            "record_equals_rollout": bool(
                torch.allclose(rec["reward"].sum(0), roll[n_state], rtol=1e-4, atol=1e-3)
                and all(torch.equal(rec[nm][-1], roll[j]) for j, nm in enumerate(c.state_names))),
        }
        checks[env_id] = ok
        mean_r = float(roll[n_state].double().sum()) / (N * T_DISPATCH)
        disp[env_id] = {"launches": delta, "mean_reward": mean_r,
                        "term_rate": float(roll[n_state + 1].double().sum()) / (N * T_DISPATCH)}
        if env_id == SYNC_TIMED:
            sc_kernel_reward = mean_r
        del roll, rec
    emit({"phase": "sync_dispatch", "envs": N, "steps": T_DISPATCH, "ids": disp, "checks": checks})
    failed = [f"{i}:{k}" for i, ok in checks.items() for k, v in ok.items() if not v]
    if failed:
        raise AssertionError(f"sync dispatch output checks failed: {failed}")

    # 16. timings at the bench width; the share of env-steps that reset
    timings = {}
    const_cc = [(SYNC_SPECIALISED, SYNC_CONST_REFS["CC"])]
    for env_id, refs in [(SYNC_SPECIALISED, None), (SYNC_TIMED, None)] + const_cc:
        env = gt.make_functional(env_id, device=dev, **({} if refs is None else {
            "reference_generator": rg.ReferenceSpec([rg.ConstReference(n, v) for n, v in refs])}))
        c = sf.SyncConsts(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(c.n_state)]
        key = ("" if env_id == SYNC_TIMED else "/" + env_id) + ("" if refs is None else "/const")
        roll = fr.make_fused_rollout(env, T_ROLLOUT, N)
        r_ms, out = cuda_ms(torch, lambda: roll(SEED, *z), reps=SYNC_REPS)
        r_bytes = sync_bytes(c, "sync_rollout_random", N, T_ROLLOUT)
        r_row = {
            "steps": T_ROLLOUT, "ms": r_ms, "env_steps_per_s": N * T_ROLLOUT / (r_ms / 1e3),
            "bound_ms": bound_ms(N * T_ROLLOUT, ops["sync_rollout_random" + key], r_bytes)[0],
            "mean_reward": float(out[c.n_state].double().sum()) / (N * T_ROLLOUT),
            "reset_share": float(out[c.n_state + 1].double().sum()) / (N * T_ROLLOUT),
            "finite": all(bool(torch.isfinite(x).all()) for x in out),
            **design_fields("sync_rollout_random" + key, N * T_ROLLOUT, r_bytes, r_ms, c)}
        if not r_row["finite"]:
            raise AssertionError(f"{env_id}: the 65536-step rollout produced non-finite values")
        if refs is not None:
            timings[env_id + "/const"] = {"sync_rollout_random": r_row}
            del out
            continue
        rec = frec.make_fused_record_rollout(env, T_RECORD, N)
        c_ms, rec_out = cuda_ms(torch, lambda: rec(SEED, *z), reps=SYNC_REPS)
        rec_bytes = sum(x.numel() * x.element_size() for x in rec_out.values())
        c_bytes = sync_bytes(c, "sync_record_random", N, T_RECORD)
        row = {
            "sync_rollout_random": r_row,
            "sync_record_random": {
                "steps": T_RECORD, "ms": c_ms, "bytes_written": rec_bytes,
                "env_steps_per_s": N * T_RECORD / (c_ms / 1e3),
                "GB_per_s": rec_bytes / (c_ms / 1e3) / 1e9,
                "bound_ms": bound_ms(N * T_RECORD, ops["sync_record_random" + key], c_bytes)[0],
                "reset_share": float(rec_out["done"].double().mean()),
                **record_design(sf, "sync")("sync_record_random" + key, N * T_RECORD, c_bytes,
                                            c_ms, c)},
        }
        if env_id == SYNC_SPECIALISED:
            pc = fs.PmsmConsts(env)
            zz = torch.zeros((R, 128), device=dev)
            p_ms, p_out = cuda_ms(
                torch, lambda: fs.pmsm_rollout_random(pc, SEED, zz, zz, zz, T_ROLLOUT), reps=5)
            p_bytes = 3 * 4 * N + 13 * 4 * N
            row["pmsm_rollout_random"] = {
                "steps": T_ROLLOUT, "ms": p_ms, "env_steps_per_s": N * T_ROLLOUT / (p_ms / 1e3),
                "bound_ms": bound_ms(N * T_ROLLOUT, ops["pmsm_rollout_random"], p_bytes)[0],
                "reset_share": float(p_out[4].double().sum()) / (N * T_ROLLOUT),
                **ring_fields(fs.pmsm_ring_layout(), "pmsm_rollout_ws", "pmsm_rollout_random",
                              "pmsm_rollout_random", N * T_ROLLOUT, p_bytes, p_ms)}
            row["universal_over_specialised"] = r_ms / p_ms
            del p_out
        timings[env_id] = row
        del out, rec_out
    env = gt.make_functional(SYNC_TIMED, device=dev)
    venv = gt.VectorEnv(env, N)
    state, _obs = venv.reset(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    policy = gt.random_cont_policy(3)
    venv.rollout(state, policy, 5, gen)  # warm-up
    gen_ms, (state, rsum, tsum) = host_ms(
        torch, lambda: venv.rollout(state, policy, T_SYNC_GENERAL, gen))
    gen_mean_r = float(rsum.double().sum()) / (N * T_SYNC_GENERAL)
    timings["general_path/" + SYNC_TIMED] = {
        "steps": T_SYNC_GENERAL, "ms": gen_ms,
        "env_steps_per_s": N * T_SYNC_GENERAL / (gen_ms / 1e3), "mean_reward": gen_mean_r,
        "term_rate": float(tsum.double().sum()) / (N * T_SYNC_GENERAL),
        "kernel_mean_reward_200": sc_kernel_reward}
    launches = dict(sf.LAUNCHES)
    emit({"phase": "sync_timings", "card": card, "envs": N, "timings": timings,
          "launches": launches})
    if not (math.isfinite(gen_mean_r) and bool(torch.isfinite(state.phys.ode_state).all())):
        raise AssertionError("the Cont-SC-PMSM-v0 general path produced non-finite values")
    # the same process in distribution: general path vs kernel over 200 steps
    # from the reset state (the bound of tests/test_pallas_sync_universal.py:104)
    if not abs(gen_mean_r - sc_kernel_reward) < 0.08:
        raise AssertionError(f"general path mean reward {gen_mean_r} vs kernel {sc_kernel_reward}")
    # each id once through the env check (buffer) and the dispatch (random);
    # cuda_ms calls twice before its reps, on 2 ids (and the rollout again
    # with constant references)
    n_ids, timed_calls = len(gt.SYNC_ENV_IDS), 2 * (2 + SYNC_REPS)
    want = {"sync_rollout_random": n_ids + timed_calls + len(const_cc) * (2 + SYNC_REPS),
            "sync_record_random": n_ids + timed_calls,
            "sync_rollout_buffer": n_ids, "sync_record_buffer": n_ids}
    if launches != want:
        raise AssertionError(f"sync kernels on the main path launched {launches}, expected {want}")

    # ---- kernels line rows ---------------------------------------------------
    replaces = {"sync_rollout_random": "gym_electric_motor_tpu/ops/pallas_sync.py:1112",
                "sync_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_sync.py:1085",
                "sync_record_random": "gym_electric_motor_tpu/ops/pallas_record.py:303",
                "sync_record_buffer": "gym_electric_motor_tpu/ops/pallas_record.py:147"}
    return family_kernel_rows(
        fam, lambda name: "gym_electric_motor_tpu_torch/csrc/fused_sync.cu", replaces, launches,
        worst, share, timed, SYNC_TIMED, len(gt.SYNC_ENV_IDS),
        {name: timings[SYNC_TIMED][name] for name in ("sync_rollout_random", "sync_record_random")})


def dc_bytes(c, kernel, n, steps):
    """Bytes a DC kernel must move for ``n`` envs and ``steps`` steps: each
    input once, each output once."""
    state = 4 * n * c.n_state
    act = 4 * c.n_ch * n * steps
    if kernel == "dc_rollout_random":
        return state + 4 * n * (c.n_state + 2) + 16 * n * c.n_ref
    if kernel == "dc_rollout_buffer":
        return 2 * state + act
    if kernel == "dc_record_random":
        return state + 4 * n * steps * (c.n_state + c.n_ref + c.n_ch + 2)
    return state + act + 4 * n * steps * c.n_state


def run_dc(dev, card, ops):
    """Slice 4, the universal DC family: the four kernels of csrc/fused_dc.cu
    and csrc/fused_dc_record.cu against their plain versions on the 24 ids,
    then the main path (env against the buffer kernels, the dispatch,
    timings) with its launches counted from zero.  Returns the DC kernels'
    rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_record as frec
    from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)

    def planes(c):
        """Speed (under a dynamic load) in [0, 100) rad/s, currents in
        +-100 A."""
        w = [rng.uniform(0, 100, (R, 128))] if c.mech else []
        return [torch.as_tensor(x.astype(np.float32), device=dev)
                for x in w + [rng.uniform(-100, 100, (R, 128)) for _ in range(c.n_el)]]

    def actions(c, steps):
        """Finite actions in 0..n-1, continuous ones uniform over the box;
        (T, [2,] R, 128)."""
        shape = (steps,) + ((2,) if c.n_ch == 2 else ()) + (R, 128)
        if c.finite:
            return torch.as_tensor(rng.integers(0, min(c.act_ns), shape).astype(np.int32),
                                   device=dev)
        lo, span = c.f["act_lo0"], c.f["act_span0"]
        return torch.as_tensor(rng.uniform(lo, lo + span, shape).astype(np.float32), device=dev)

    def env_actions(c, a):
        """One step of a buffer as the env takes it: (N,), (N, 1) or (N, 2)."""
        if c.n_ch == 2:
            return a.reshape(2, N).T.contiguous()
        return a.reshape(N) if c.finite else a.reshape(N, 1)

    # ---- 18. the four kernels against their plain versions, every id -----
    fam = SimpleNamespace(
        mod=dcf, prefix="dc", consts=dcf.DcConsts, planes=planes, actions=actions,
        nbytes=dc_bytes, angle=lambda c, n: [False] * n,
        cols=lambda c: ([0] if c.mech else []) + [1, 2][:c.n_el], env_action=env_actions)
    worst, share, timed = compare_family_kernels(torch, gt, dev, fam, gt.DC_ENV_IDS, DC_TIMED,
                                                 (DC_BENCH, DC_TIMED), ops)

    def dc_const_refs(env_id):
        _a, task, motor, _v = env_id.split("-")
        return DC_CONST_REFS[task][motor] if task == "CC" else DC_CONST_REFS[task]

    # the warp-specialised random rollout and recorder, bit for bit on every id
    hold_bit_equal(torch, gt, rg, dev, fam, gt.DC_ENV_IDS, dc_const_refs, worst, share,
                   ("rollout", "record"))

    # ---- 19.-21. the main path: counts from zero ---------------------------
    fs.reset_launches()
    fp.reset_launches()
    sf.reset_launches()
    dcf.reset_launches()

    def others_launched():
        return any(fs.LAUNCHES.values()) or any(fp.LAUNCHES.values()) \
            or any(sf.LAUNCHES.values())

    # 19. the env against the buffer kernels, through the dispatch
    # (rtol 1e-4 / atol 1e-3, tests/test_pallas_dc_universal.py:83-85)
    env_rows = {env_id: env_vs_buffer_kernels(torch, gt, rg, fr, frec, dev, fam, env_id,
                                              dc_const_refs(env_id), 1e-3)
                for env_id in gt.DC_ENV_IDS}
    emit({"phase": "dc_env", "envs": N, "steps": T_SYNC_ENV, "ids": env_rows})

    # 20. the dispatch: exactly one launch of each random kernel per id
    disp, checks = {}, {}
    for env_id in gt.DC_ENV_IDS:
        env = gt.make_functional(env_id, device=dev)
        n_state = fr.fused_state_arity(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(n_state)]
        before = dict(dcf.LAUNCHES)
        roll = fr.make_fused_rollout(env, T_DISPATCH, N)(SEED, *z)
        rec = frec.make_fused_record_rollout(env, T_DISPATCH, N)(SEED, *z)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in dcf.LAUNCHES.items() if v != before[k]}
        if delta != {"dc_rollout_random": 1, "dc_record_random": 1} or others_launched():
            raise AssertionError(f"{env_id}: the dispatch launched {delta} (other kernels: "
                                 f"{others_launched()}), expected one dc_rollout_random and one "
                                 "dc_record_random")
        c = dcf.DcConsts(env)
        rv = roll[n_state + 2]
        lo = min(row["mlo"] for row in c.rows)
        hi = max(row["mhi"] for row in c.rows)
        lims = [c.f["lim0"], c.f["lim1"]][:c.n_el]
        ok = {
            "finite": all(bool(torch.isfinite(x).all()) for x in roll)
            and all(bool(torch.isfinite(x.float()).all()) for x in rec.values()),
            "in_current_limits": all(bool((roll[n_state - c.n_el + j].abs() <= lim).all())
                                     for j, lim in enumerate(lims)),
            "ref_in_margin": bool(((rv >= lo - 1e-6) & (rv <= hi + 1e-6)).all()),
            "record_equals_rollout": bool(
                torch.allclose(rec["reward"].sum(0), roll[n_state], rtol=1e-4, atol=1e-3)
                and all(torch.equal(rec[nm][-1], roll[j]) for j, nm in enumerate(c.state_names))),
        }
        checks[env_id] = ok
        disp[env_id] = {"launches": delta,
                        "mean_reward": float(roll[n_state].double().sum()) / (N * T_DISPATCH),
                        "term_rate": float(roll[n_state + 1].double().sum()) / (N * T_DISPATCH)}
        del roll, rec
    emit({"phase": "dc_dispatch", "envs": N, "steps": T_DISPATCH, "ids": disp, "checks": checks})
    failed = [f"{i}:{k}" for i, ok in checks.items() for k, v in ok.items() if not v]
    if failed:
        raise AssertionError(f"DC dispatch output checks failed: {failed}")

    # 21. timings at the bench width
    timings = {}
    bench_const = gt.make_functional(DC_BENCH, device=dev,
                                     reference_generator=rg.ConstReference("i", 0.3))
    for label, env, key in ((DC_BENCH, gt.make_functional(DC_BENCH, device=dev),
                             "/" + DC_BENCH),
                            (DC_BENCH + "/const_i_0.3", bench_const, "/" + DC_BENCH + "/const"),
                            (DC_TIMED, gt.make_functional(DC_TIMED, device=dev), "")):
        c = dcf.DcConsts(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(c.n_state)]
        roll = fr.make_fused_rollout(env, T_ROLLOUT, N)
        r_ms, out = cuda_ms(torch, lambda: roll(SEED, *z), reps=SYNC_REPS)
        row = {"dc_rollout_random": {
            "steps": T_ROLLOUT, "ms": r_ms, "env_steps_per_s": N * T_ROLLOUT / (r_ms / 1e3),
            "bound_ms": bound_ms(N * T_ROLLOUT, ops["dc_rollout_random" + key],
                                 dc_bytes(c, "dc_rollout_random", N, T_ROLLOUT))[0],
            "mean_reward": float(out[c.n_state].double().sum()) / (N * T_ROLLOUT),
            "term_rate": float(out[c.n_state + 1].double().sum()) / (N * T_ROLLOUT),
            "reset_share": float(out[c.n_state + 1].double().sum()) / (N * T_ROLLOUT),
            "finite": all(bool(torch.isfinite(x).all()) for x in out)}}
        row["dc_rollout_random"].update(design_fields(
            "dc_rollout_random" + key, N * T_ROLLOUT, dc_bytes(c, "dc_rollout_random", N, T_ROLLOUT),
            r_ms, c))
        if not row["dc_rollout_random"]["finite"]:
            raise AssertionError(f"{label}: the 65536-step rollout produced non-finite values")
        if not label.endswith("const_i_0.3"):
            rec = frec.make_fused_record_rollout(env, T_RECORD, N)
            c_ms, rec_out = cuda_ms(torch, lambda: rec(SEED, *z), reps=SYNC_REPS)
            rec_bytes = sum(x.numel() * x.element_size() for x in rec_out.values())
            row["dc_record_random"] = {
                "steps": T_RECORD, "ms": c_ms, "bytes_written": rec_bytes,
                "env_steps_per_s": N * T_RECORD / (c_ms / 1e3),
                "GB_per_s": rec_bytes / (c_ms / 1e3) / 1e9,
                "bound_ms": bound_ms(N * T_RECORD, ops["dc_record_random" + key],
                                     dc_bytes(c, "dc_record_random", N, T_RECORD))[0],
                "reset_share": float(rec_out["done"].double().mean()),
                **record_design(dcf, "dc")("dc_record_random" + key, N * T_RECORD,
                                           dc_bytes(c, "dc_record_random", N, T_RECORD), c_ms, c)}
            del rec_out
        timings[label] = row
        del out
    env = gt.make_functional(DC_GENERAL, device=dev)
    venv = gt.VectorEnv(env, N)
    state, _obs = venv.reset(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    policy = gt.random_policy_for(env)
    venv.rollout(state, policy, 5, gen)  # warm-up
    gen_ms, (state, rsum, tsum) = host_ms(
        torch, lambda: venv.rollout(state, policy, T_SYNC_GENERAL, gen))
    gen_mean_r = float(rsum.double().sum()) / (N * T_SYNC_GENERAL)
    kernel_r = disp[DC_GENERAL]["mean_reward"]
    timings["general_path/" + DC_GENERAL] = {
        "steps": T_SYNC_GENERAL, "ms": gen_ms,
        "env_steps_per_s": N * T_SYNC_GENERAL / (gen_ms / 1e3), "mean_reward": gen_mean_r,
        "term_rate": float(tsum.double().sum()) / (N * T_SYNC_GENERAL),
        "kernel_mean_reward_200": kernel_r}
    launches = {name: dcf.LAUNCHES[name] for name in dcf.KERNELS}
    emit({"phase": "dc_timings", "card": card, "envs": N, "timings": timings,
          "launches": launches})
    if not (math.isfinite(gen_mean_r) and bool(torch.isfinite(state.phys.ode_state).all())):
        raise AssertionError(f"the {DC_GENERAL} general path produced non-finite values")
    # the same process in distribution: general path vs kernel over 200 steps
    # from the reset state (the bound of tests/test_pallas_dc_universal.py:113)
    if not abs(gen_mean_r - kernel_r) < 0.08:
        raise AssertionError(f"general path mean reward {gen_mean_r} vs kernel {kernel_r}")
    # each id once through the env check (buffer) and the dispatch (random);
    # cuda_ms calls twice before its reps: 3 rollout and 2 recorder timings
    n_ids, per_timing = len(gt.DC_ENV_IDS), 2 + SYNC_REPS
    want = {"dc_rollout_random": n_ids + 3 * per_timing,
            "dc_record_random": n_ids + 2 * per_timing,
            "dc_rollout_buffer": n_ids, "dc_record_buffer": n_ids}
    if launches != want or others_launched():
        raise AssertionError(f"DC kernels on the main path launched {launches} (other kernels: "
                             f"{others_launched()}), expected {want}")

    # ---- kernels line rows ---------------------------------------------------
    replaces = {"dc_rollout_random": "gym_electric_motor_tpu/ops/pallas_dc.py:1266",
                "dc_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_dc.py:1240",
                "dc_record_random": "gym_electric_motor_tpu/ops/pallas_record.py:303",
                "dc_record_buffer": "gym_electric_motor_tpu/ops/pallas_record.py:147"}
    return family_kernel_rows(
        fam, lambda name: f"gym_electric_motor_tpu_torch/csrc/{dcf.LIBRARY[name]}.cu", replaces,
        launches, worst, share, timed, DC_TIMED, len(gt.DC_ENV_IDS),
        {name: timings[DC_TIMED][name] for name in ("dc_rollout_random", "dc_record_random")})


def family_main_path(torch, gt, dev, card, fam, ids, const_refs, atol, timed_ids, record_ids,
                     ops, others, dispatch_checks, annotate=None, const_timed=(),
                     record_annotate=None):
    """The main path of a universal family (the induction, EESM, DFIM and
    SRM slices), its launches counted from zero: the env against both
    buffer kernels on every id of ``ids`` (constant references
    ``const_refs[task]``, tolerance ``atol``), the dispatch (exactly one
    launch of each random kernel per id and none of the ``others`` modules'
    kernels; output checks, with ``dispatch_checks(c, roll, n_state)`` the
    family's own), then the timings at the bench width: the random rollout
    at T_ROLLOUT steps on ``timed_ids``, the random recorder at T_RECORD on
    ``record_ids``, each with its share of env-steps that reset, and the
    general path on the last of ``timed_ids`` (the instance the bounds
    count); ``annotate(key, env_steps, nbytes, ms, c)`` adds fields to each
    timed rollout's row, ``record_annotate`` (the same signature) to each
    timed recorder's; ``const_timed`` holds ``(id, references)`` whose
    rollout is timed again with those constant references (key
    ``/<id>/const``).  Returns the family's launches on the path and the
    timings."""
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_record as frec
    from gym_electric_motor_tpu_torch.ops import fused_rollout as fr

    mod, pre = fam.mod, fam.prefix
    rollout, record = f"{pre}_rollout_random", f"{pre}_record_random"
    timed_id = timed_ids[-1]
    N, R = N_ENVS, N_ENVS // 128
    for module in others + (mod,):
        module.reset_launches()

    def others_launched():
        return any(any(m.LAUNCHES.values()) for m in others)

    # the env against the buffer kernels, through the dispatch
    env_rows = {env_id: env_vs_buffer_kernels(torch, gt, rg, fr, frec, dev, fam, env_id,
                                              const_refs[env_id.split("-")[1]], atol)
                for env_id in ids}
    emit({"phase": f"{pre}_env", "envs": N, "steps": T_SYNC_ENV, "ids": env_rows})

    # the dispatch: exactly one launch of each random kernel per id
    disp, checks = {}, {}
    for env_id in ids:
        env = gt.make_functional(env_id, device=dev)
        n_state = fr.fused_state_arity(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(n_state)]
        before = dict(mod.LAUNCHES)
        roll = fr.make_fused_rollout(env, T_DISPATCH, N)(SEED, *z)
        rec = frec.make_fused_record_rollout(env, T_DISPATCH, N)(SEED, *z)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in mod.LAUNCHES.items() if v != before[k]}
        if delta != {rollout: 1, record: 1} or others_launched():
            raise AssertionError(f"{env_id}: the dispatch launched {delta} (other kernels: "
                                 f"{others_launched()}), expected one {rollout} and one {record}")
        c = fam.consts(env)
        rv = roll[n_state + 2]
        lo = min(row["mlo"] for row in c.rows)
        hi = max(row["mhi"] for row in c.rows)
        ok = {
            "finite": all(bool(torch.isfinite(x).all()) for x in roll)
            and all(bool(torch.isfinite(x.float()).all()) for x in rec.values()),
            **dispatch_checks(c, roll, n_state),
            "ref_in_margin": bool(((rv >= lo - 1e-6) & (rv <= hi + 1e-6)).all()),
            "record_equals_rollout": bool(
                torch.allclose(rec["reward"].sum(0), roll[n_state], rtol=1e-4, atol=1e-3)
                and all(torch.equal(rec[nm][-1], roll[j]) for j, nm in enumerate(c.state_names))),
        }
        checks[env_id] = ok
        disp[env_id] = {"launches": delta,
                        "mean_reward": float(roll[n_state].double().sum()) / (N * T_DISPATCH),
                        "reset_share": float(roll[n_state + 1].double().sum()) / (N * T_DISPATCH)}
        del roll, rec
    emit({"phase": f"{pre}_dispatch", "envs": N, "steps": T_DISPATCH, "ids": disp,
          "checks": checks})
    failed = [f"{i}:{k}" for i, ok in checks.items() for k, v in ok.items() if not v]
    if failed:
        raise AssertionError(f"{pre} dispatch output checks failed: {failed}")

    # timings at the bench width; the share of env-steps that reset
    timings = {}
    timed = [(env_id, None) for env_id in timed_ids] + list(const_timed)
    for env_id, refs in timed:
        env = gt.make_functional(env_id, device=dev, **({} if refs is None else {
            "reference_generator": rg.ReferenceSpec([rg.ConstReference(n, v) for n, v in refs])}))
        c = fam.consts(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(c.n_state)]
        key = ("" if env_id == timed_id else "/" + env_id) + ("" if refs is None else "/const")
        roll = fr.make_fused_rollout(env, T_ROLLOUT, N)
        r_ms, out = cuda_ms(torch, lambda: roll(SEED, *z), reps=SYNC_REPS)
        row = {rollout: {
            "steps": T_ROLLOUT, "ms": r_ms, "env_steps_per_s": N * T_ROLLOUT / (r_ms / 1e3),
            "bound_ms": bound_ms(N * T_ROLLOUT, ops[rollout + key],
                                 fam.nbytes(c, rollout, N, T_ROLLOUT))[0],
            "mean_reward": float(out[c.n_state].double().sum()) / (N * T_ROLLOUT),
            "reset_share": float(out[c.n_state + 1].double().sum()) / (N * T_ROLLOUT),
            "finite": all(bool(torch.isfinite(x).all()) for x in out)}}
        if annotate:
            row[rollout].update(annotate(rollout + key, N * T_ROLLOUT,
                                         fam.nbytes(c, rollout, N, T_ROLLOUT), r_ms, c))
        if not row[rollout]["finite"]:
            raise AssertionError(f"{env_id}: the 65536-step rollout produced non-finite values")
        if env_id in record_ids and refs is None:
            rec = frec.make_fused_record_rollout(env, T_RECORD, N)
            c_ms, rec_out = cuda_ms(torch, lambda: rec(SEED, *z), reps=SYNC_REPS)
            rec_bytes = sum(x.numel() * x.element_size() for x in rec_out.values())
            row[record] = {
                "steps": T_RECORD, "ms": c_ms, "bytes_written": rec_bytes,
                "env_steps_per_s": N * T_RECORD / (c_ms / 1e3),
                "GB_per_s": rec_bytes / (c_ms / 1e3) / 1e9,
                "bound_ms": bound_ms(N * T_RECORD, ops[record + key],
                                     fam.nbytes(c, record, N, T_RECORD))[0],
                "reset_share": float(rec_out["done"].double().mean())}
            if record_annotate:
                row[record].update(record_annotate(record + key, N * T_RECORD,
                                                   fam.nbytes(c, record, N, T_RECORD), c_ms, c))
            del rec_out
        timings[env_id + ("" if refs is None else "/const")] = row
        del out
    env = gt.make_functional(timed_id, device=dev)
    venv = gt.VectorEnv(env, N)
    state, _obs = venv.reset(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    policy = gt.random_policy_for(env)
    venv.rollout(state, policy, 5, gen)  # warm-up
    gen_ms, (state, rsum, tsum) = host_ms(
        torch, lambda: venv.rollout(state, policy, T_SYNC_GENERAL, gen))
    gen_mean_r = float(rsum.double().sum()) / (N * T_SYNC_GENERAL)
    kernel_r = disp[timed_id]["mean_reward"]
    timings["general_path/" + timed_id] = {
        "steps": T_SYNC_GENERAL, "ms": gen_ms,
        "env_steps_per_s": N * T_SYNC_GENERAL / (gen_ms / 1e3), "mean_reward": gen_mean_r,
        "reset_share": float(tsum.double().sum()) / (N * T_SYNC_GENERAL),
        "kernel_mean_reward_200": kernel_r}
    launches = {name: mod.LAUNCHES[name] for name in mod.KERNELS}
    emit({"phase": f"{pre}_timings", "card": card, "envs": N, "timings": timings,
          "launches": launches})
    if not (math.isfinite(gen_mean_r) and bool(torch.isfinite(state.phys.ode_state).all())):
        raise AssertionError(f"the {timed_id} general path produced non-finite values")
    # the same process in distribution: general path vs kernel over 200 steps
    # from the reset state (the bound of tests/test_pallas_families.py:212)
    if not abs(gen_mean_r - kernel_r) < 0.08:
        raise AssertionError(f"general path mean reward {gen_mean_r} vs kernel {kernel_r}")
    # each id once through the env check (buffer) and the dispatch (random);
    # cuda_ms calls twice before its reps
    n_ids, per_timing = len(ids), 2 + SYNC_REPS
    want = {rollout: n_ids + len(timed) * per_timing,
            record: n_ids + len(record_ids) * per_timing,
            f"{pre}_rollout_buffer": n_ids, f"{pre}_record_buffer": n_ids}
    if launches != want or others_launched():
        raise AssertionError(f"{pre} kernels on the main path launched {launches} (other "
                             f"kernels: {others_launched()}), expected {want}")
    return launches, timings


def run_induction(dev, card, ops):
    """Slice 5, the universal induction family: the four kernels of
    csrc/fused_induction.cu and csrc/fused_induction_record.cu against their
    plain versions on the six SCIM ids, then the main path (env against the
    buffer kernels, the dispatch, timings) with its launches counted from
    zero.  Returns the induction kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)

    def planes(c):
        """Speed (under a dynamic load) in [0, 100) rad/s, currents within
        6 A (the limit is 5.5 A, so some random-mode envs reset at once),
        fluxes within 0.5 Wb."""
        bounds = ([(0, 100)] if c.mech else []) + [(-6, 6)] * 2 + [(-0.5, 0.5)] * 2
        return [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
                for lo, hi in bounds]

    def actions(c, steps):
        if c.finite:
            return torch.as_tensor(rng.integers(0, 8, (steps, R, 128)).astype(np.int32), device=dev)
        return torch.as_tensor(rng.uniform(-1.0, 1.0, (steps, 3, R, 128)).astype(np.float32),
                               device=dev)

    # ---- 22. the four kernels against their plain versions, every id -----
    fam = SimpleNamespace(
        mod=indf, prefix="induction", consts=indf.InductionConsts, planes=planes,
        actions=actions, nbytes=sync_bytes, angle=lambda c, n: [False] * n,
        cols=lambda c: ([0] if c.mech else []) + [1, 2, 3, 4],
        env_action=lambda c, a: a.reshape(N) if c.finite else a.reshape(3, N).T.contiguous())
    worst, share, timed = compare_family_kernels(torch, gt, dev, fam, gt.SCIM_ENV_IDS, IND_TIMED,
                                                 (IND_CC, IND_TIMED), ops)
    # the warp-specialised random rollout and recorder, bit for bit on every id
    hold_bit_equal(torch, gt, rg, dev, fam, gt.SCIM_ENV_IDS,
                   lambda env_id: SYNC_CONST_REFS[env_id.split("-")[1]], worst, share,
                   ("rollout", "record"))

    # ---- 23.-25. the main path: counts from zero ---------------------------
    # 23. the env against the buffer kernels (rtol 1e-4 / atol 2e-3,
    # tests/test_pallas_families.py:70-72); 24. the dispatch, with the
    # currents inside the limit circle; 25. timings
    def in_circle(c, roll, n_state):
        isa, isb = roll[n_state - 4], roll[n_state - 3]
        return {"in_current_circle": bool(((isa * isa + isb * isb) * c.f["inv_ilim2"]
                                           <= 1.0 + 1e-5).all())}

    launches, timings = family_main_path(
        torch, gt, dev, card, fam, gt.SCIM_ENV_IDS, SYNC_CONST_REFS, 2e-3,
        (IND_BENCH, IND_CC, IND_TIMED), (IND_CC, IND_TIMED), ops, (fs, fp, sf, dcf), in_circle,
        design_fields, ((IND_BENCH, SYNC_CONST_REFS["TC"]),), record_design(indf, "induction"))

    # ---- kernels line rows ---------------------------------------------------
    replaces = {"induction_rollout_random": "gym_electric_motor_tpu/ops/pallas_induction.py:859",
                "induction_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_induction.py:833",
                "induction_record_random": "gym_electric_motor_tpu/ops/pallas_record.py:303",
                "induction_record_buffer": "gym_electric_motor_tpu/ops/pallas_record.py:147"}
    return family_kernel_rows(
        fam, lambda name: f"gym_electric_motor_tpu_torch/csrc/{indf.LIBRARY[name]}.cu", replaces,
        launches, worst, share, timed, IND_TIMED, len(gt.SCIM_ENV_IDS),
        {name: timings[IND_TIMED][name]
         for name in ("induction_rollout_random", "induction_record_random")})


def run_eesm(dev, card, ops):
    """Slice 6, the universal EESM family: the four kernels of
    csrc/fused_eesm.cu and csrc/fused_eesm_record.cu against their plain
    versions on the six EESM ids, then the main path (env against the buffer
    kernels, the dispatch, timings) with its launches counted from zero.
    Returns the EESM kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)

    def planes(c):
        """Speed (under a dynamic load) in [0, 100) rad/s, the three currents
        within 170 A (the limits are 150 A, so some random-mode envs reset at
        once), the angle in [0, 2 pi)."""
        bounds = ([(0, 100)] if c.mech else []) + [(-170, 170)] * 3 + [(0, 2 * np.pi)]
        return [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
                for lo, hi in bounds]

    def actions(c, steps):
        """int32 (T, 2, R, 128) B6 bits and 4QC actions, or float32
        (T, 4, R, 128) duties."""
        if c.finite:
            a = np.stack([rng.integers(0, 8, (steps, R, 128)), rng.integers(0, 4, (steps, R, 128))],
                         axis=1)
            return torch.as_tensor(a.astype(np.int32), device=dev)
        return torch.as_tensor(rng.uniform(-1.0, 1.0, (steps, 4, R, 128)).astype(np.float32),
                               device=dev)

    # ---- 26. the four kernels against their plain versions, every id -----
    fam = SimpleNamespace(
        mod=ef, prefix="eesm", consts=ef.EesmConsts, planes=planes, actions=actions,
        nbytes=sync_bytes, angle=lambda c, n: [j == c.n_state - 1 for j in range(n)],
        cols=lambda c: ([0] if c.mech else []) + [1, 2, 3, 4],
        env_action=lambda c, a: a.reshape(c.n_act, N).T.contiguous())
    worst, share, timed = compare_family_kernels(torch, gt, dev, fam, gt.EESM_ENV_IDS, EESM_TIMED,
                                                 (EESM_BENCH, EESM_TIMED), ops)
    # the warp-specialised random rollout and recorder, bit for bit on every id
    hold_bit_equal(torch, gt, rg, dev, fam, gt.EESM_ENV_IDS,
                   lambda env_id: EESM_CONST_REFS[env_id.split("-")[1]], worst, share,
                   ("rollout", "record"))

    # ---- 27.-29. the main path: counts from zero ---------------------------
    # 27. the env against the buffer kernels (rtol 1e-4 / atol 2e-3, angles
    # modulo 2 pi, tests/test_pallas_families.py:61-72); 28. the dispatch,
    # with the angle in range and the currents inside their limits; 29.
    # timings
    def in_limits(c, roll, n_state):
        i_sd, i_sq, i_e, eps = roll[n_state - 4:n_state]
        i_n = c.f["inv_i_lim"]
        return {
            # [0, 2 pi] in float32: a tiny negative angle wraps to 2 pi exactly
            "eps_in_range": bool(((eps >= 0) & (eps <= float(np.float32(2 * math.pi)))).all()),
            "in_current_limits": bool((((i_sd * i_n) ** 2 + (i_sq * i_n) ** 2) <= 1.0 + 1e-5).all()
                                      and ((i_e * c.f["inv_ie_lim"]).abs() <= 1.0).all())}

    launches, timings = family_main_path(
        torch, gt, dev, card, fam, gt.EESM_ENV_IDS, EESM_CONST_REFS, 2e-3,
        (EESM_BENCH, EESM_TC, EESM_TIMED), (EESM_BENCH, EESM_TIMED), ops,
        (fs, fp, sf, dcf, indf), in_limits, design_fields,
        ((EESM_BENCH, EESM_CONST_REFS["CC"]),), record_design(ef, "eesm"))

    # ---- kernels line rows ---------------------------------------------------
    replaces = {"eesm_rollout_random": "gym_electric_motor_tpu/ops/pallas_eesm.py:902",
                "eesm_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_eesm.py:875",
                "eesm_record_random": "gym_electric_motor_tpu/ops/pallas_record.py:303",
                "eesm_record_buffer": "gym_electric_motor_tpu/ops/pallas_record.py:147"}
    return family_kernel_rows(
        fam, lambda name: f"gym_electric_motor_tpu_torch/csrc/{ef.LIBRARY[name]}.cu", replaces,
        launches, worst, share, timed, EESM_TIMED, len(gt.EESM_ENV_IDS),
        {name: timings[EESM_TIMED][name] for name in ("eesm_rollout_random", "eesm_record_random")})


def run_dfim(dev, card, ops):
    """Slice 7, the universal DFIM family: the four kernels of
    csrc/fused_dfim.cu and csrc/fused_dfim_record.cu against their plain
    versions on the six DFIM ids, then the main path (env against the buffer
    kernels, the dispatch, timings) with its launches counted from zero.
    Returns the DFIM kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)

    def planes(c):
        """Speed (under a dynamic load) in [0, 100) rad/s, the stator
        currents within 10 A (the limit is 9 A, so some random-mode envs
        reset at once), the fluxes within 1.5 Wb, the angle in [0, 2 pi)."""
        bounds = (([(0, 100)] if c.mech else []) + [(-10, 10)] * 2 + [(-1.5, 1.5)] * 2
                  + [(0, 2 * np.pi)])
        return [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
                for lo, hi in bounds]

    def actions(c, steps):
        """int32 (T, 2, R, 128) stator and rotor bits, or float32
        (T, 6, R, 128) duties."""
        if c.finite:
            return torch.as_tensor(rng.integers(0, 8, (steps, 2, R, 128)).astype(np.int32),
                                   device=dev)
        return torch.as_tensor(rng.uniform(-1.0, 1.0, (steps, 6, R, 128)).astype(np.float32),
                               device=dev)

    # ---- 30. the four kernels against their plain versions, every id -----
    fam = SimpleNamespace(
        mod=dff, prefix="dfim", consts=dff.DfimConsts, planes=planes, actions=actions,
        nbytes=sync_bytes, angle=lambda c, n: [j == c.n_state - 1 for j in range(n)],
        cols=lambda c: ([0] if c.mech else []) + [1, 2, 3, 4, 5],
        env_action=lambda c, a: a.reshape(c.n_act, N).T.contiguous())
    worst, share, timed = compare_family_kernels(torch, gt, dev, fam, gt.DFIM_ENV_IDS, DFIM_TIMED,
                                                 (DFIM_BENCH, DFIM_TIMED), ops)
    # the warp-specialised random rollout and recorder, bit for bit on every id
    hold_bit_equal(torch, gt, rg, dev, fam, gt.DFIM_ENV_IDS,
                   lambda env_id: SYNC_CONST_REFS[env_id.split("-")[1]], worst, share,
                   ("rollout", "record"))

    # ---- 31.-33. the main path: counts from zero ---------------------------
    # 31. the env against the buffer kernels (rtol 1e-4 / atol 2e-3, angles
    # modulo 2 pi, tests/test_pallas_families.py:61-72); 32. the dispatch,
    # with the angle in range and the currents inside the limit circle; 33.
    # timings
    def in_limits(c, roll, n_state):
        isa, isb, eps = roll[n_state - 5], roll[n_state - 4], roll[n_state - 1]
        return {
            # [0, 2 pi] in float32: a tiny negative angle wraps to 2 pi exactly
            "eps_in_range": bool(((eps >= 0) & (eps <= float(np.float32(2 * math.pi)))).all()),
            "in_current_circle": bool(((isa * isa + isb * isb) * c.f["inv_ilim2"]
                                       <= 1.0 + 1e-5).all())}

    launches, timings = family_main_path(
        torch, gt, dev, card, fam, gt.DFIM_ENV_IDS, SYNC_CONST_REFS, 2e-3,
        (DFIM_BENCH, DFIM_CC, DFIM_TIMED), (DFIM_BENCH, DFIM_TIMED), ops,
        (fs, fp, sf, dcf, indf, ef), in_limits, design_fields,
        record_annotate=record_design(dff, "dfim"))

    # ---- kernels line rows ---------------------------------------------------
    replaces = {"dfim_rollout_random": "gym_electric_motor_tpu/ops/pallas_dfim.py:974",
                "dfim_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_dfim.py:947",
                "dfim_record_random": "gym_electric_motor_tpu/ops/pallas_record.py:303",
                "dfim_record_buffer": "gym_electric_motor_tpu/ops/pallas_record.py:147"}
    return family_kernel_rows(
        fam, lambda name: f"gym_electric_motor_tpu_torch/csrc/{dff.LIBRARY[name]}.cu", replaces,
        launches, worst, share, timed, DFIM_TIMED, len(gt.DFIM_ENV_IDS),
        {name: timings[DFIM_TIMED][name] for name in ("dfim_rollout_random", "dfim_record_random")})


def run_srm(dev, card, ops):
    """Slice 8, the universal SRM family: the four kernels of
    csrc/fused_srm.cu and csrc/fused_srm_record.cu against their plain
    versions on the six SRM ids and on two with the saturating flux model,
    then the main path (env against the buffer kernels, the dispatch,
    timings) with its launches counted from zero.  Returns the SRM kernels'
    rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)

    def planes(c):
        """Speed (under a dynamic load) in [0, 100) rad/s, the three phase
        currents in [0, 22) A (the limit is 20 A, so some random-mode envs
        reset at once), the angle in [-pi, pi)."""
        bounds = ([(0, 100)] if c.mech else []) + [(0, 22)] * 3 + [(-np.pi, np.pi)]
        return [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
                for lo, hi in bounds]

    def actions(c, steps, duty=1.0):
        """int32 (T, 3, R, 128) per-phase commands in {0, 1, 2}, or float32
        (T, 3, R, 128) duties in [-duty, duty)."""
        if c.finite:
            return torch.as_tensor(rng.integers(0, 3, (steps, 3, R, 128)).astype(np.int32),
                                   device=dev)
        return torch.as_tensor(rng.uniform(-duty, duty, (steps, 3, R, 128)).astype(np.float32),
                               device=dev)

    # ---- 34. the four kernels against their plain versions, every id -----
    fam = SimpleNamespace(
        mod=srf, prefix="srm", consts=srf.SrmConsts, planes=planes, actions=actions,
        nbytes=sync_bytes, angle=lambda c, n: [j == c.n_state - 1 for j in range(n)],
        cols=lambda c: ([0] if c.mech else []) + [1, 2, 3, 4],
        env_action=lambda c, a: a.reshape(c.n_act, N).T.contiguous())
    worst, share, timed = compare_family_kernels(torch, gt, dev, fam, gt.SRM_ENV_IDS, SRM_TIMED,
                                                 (SRM_BENCH, SRM_TIMED), ops)
    # the saturating instances: every kernel, error 0 and every env as above.
    # The continuous buffer takes duties in [-0.5, 0.5), as the JAX suite's
    # saturating parity does (tests/test_srm.py:265-305): the incremental
    # inductance l_k exp(-i l_k / psi_s) falls as a current grows, and with
    # full duties some 0.7% of envs, which no reset stops in buffer mode,
    # pass the explicit RK4's stability limit within 128 steps and run to
    # inf in kernel and plain version alike.
    fam_sat = SimpleNamespace(**{**vars(fam), "actions": lambda c, steps: actions(c, steps, 0.5)})
    w_sat, s_sat, _ = compare_family_kernels(torch, gt, dev, fam_sat, SRM_SAT_IDS, None, (), ops,
                                             env_kw=SRM_SAT)
    for name in srf.KERNELS:
        worst[name] = max(worst[name], w_sat[name])
        share[name] = min(share[name], s_sat[name])
    # the random rollout, on lane groups or one thread per env, and the
    # random recorder, on its ring on the continuous ids, equal their plain
    # versions bit for bit, every env
    for name in ("srm_rollout_random", "srm_record_random"):
        if worst[name] != 0.0 or share[name] != 1.0:
            raise AssertionError(f"{name}: max abs err {worst[name]}, {share[name]} of envs "
                                 "match (need 0 and 1)")

    # ---- 35.-37. the main path: counts from zero ---------------------------
    # 35. the env against the buffer kernels (rtol 1e-4 / atol 2e-3, angles
    # modulo 2 pi, tests/test_srm.py:145-178); 36. the dispatch, with the
    # clamped currents inside their limit and the angle in range; 37.
    # timings
    def in_limits(c, roll, n_state):
        i3, eps = roll[n_state - 4:n_state - 1], roll[n_state - 1]
        lim = 1.0 / c.f["inv_ilim"]
        pi32 = float(np.float32(math.pi))
        return {
            "currents_clamped": all(bool((i >= 0.0).all()) for i in i3),
            "in_current_limit": all(bool((i <= lim * (1.0 + 1e-5)).all()) for i in i3),
            # [-pi, pi] in float32: the wrap's product can land on pi exactly
            "eps_in_range": bool(((eps >= -pi32) & (eps <= pi32)).all())}

    launches, timings = family_main_path(
        torch, gt, dev, card, fam, gt.SRM_ENV_IDS, SRM_CONST_REFS, 2e-3,
        (SRM_BENCH, SRM_TC, SRM_TIMED), (SRM_BENCH, SRM_TIMED), ops,
        (fs, fp, sf, dcf, indf, ef, dff), in_limits, lane_fields,
        record_annotate=record_design(srf, "srm"))

    # ---- kernels line rows ---------------------------------------------------
    replaces = {"srm_rollout_random": "gym_electric_motor_tpu/ops/pallas_srm.py:609",
                "srm_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_srm.py:581",
                "srm_record_random": "gym_electric_motor_tpu/ops/pallas_record.py:303",
                "srm_record_buffer": "gym_electric_motor_tpu/ops/pallas_record.py:147"}
    return family_kernel_rows(
        fam, lambda name: f"gym_electric_motor_tpu_torch/csrc/{srf.LIBRARY[name]}.cu", replaces,
        launches, worst, share, timed, SRM_TIMED, len(gt.SRM_ENV_IDS) + len(SRM_SAT_IDS),
        {name: timings[SRM_TIMED][name] for name in ("srm_rollout_random", "srm_record_random")})


def pu_weights(torch, rng, pol, hidden, dev):
    """Flat (w1, b1, w2, b2) of the universal recorder drawn from numpy:
    N(0, 0.5^2) weights (0.3 for a continuous env) and N(0, 0.1^2) biases;
    and log-stds -0.5 for a continuous env (None for a finite one)."""
    import numpy as np

    scale = 0.3 if pol.cont else 0.5
    sizes = ((pol.obs_dim * hidden, scale), (hidden, 0.1), (hidden * pol.n_out, scale),
             (pol.n_out, 0.1))
    w = [torch.as_tensor((rng.normal(size=n) * sc).astype(np.float32), device=dev)
         for n, sc in sizes]
    ls = (torch.full((len(pol.consts.act_names),), -0.5, device=dev) if pol.cont else None)
    return w, ls


def pu_bytes(pol, n, steps, hidden):
    """Bytes the universal recorder must move: the state planes and the
    weights read once, every recorded signal written once."""
    c = pol.consts
    weights = 4 * (pol.obs_dim * hidden + hidden + hidden * pol.n_out + pol.n_out
                   + (len(c.act_names) if pol.cont else 0))
    return 4 * n * c.n_state + weights + 4 * n * steps * len(pol.dtypes)


def pu_ops(ops, key, hidden):
    """A step's instructions per pipe at ``hidden`` units: the step loop's
    count plus H times its hidden-unit loop's (tools/sass_ops.py)."""
    inner = ops[key + "/inner"]
    return {k: v + hidden * inner[k] for k, v in ops[key].items()}


def pu_design_fields(fp, kernel, key, n, env_steps, nbytes, ms):
    """The design fields of a timed universal recorder at ``n`` envs (phase
    42): the layout its launch takes (fp.policy_universal_layout) and, on
    lane groups where tools/sass_ops.py counts that design
    (``<kernel>_lanes[/8][/<id>]``, an eight-lane design's key with /8),
    registers, a lane's counts, the
    issue bound of G lanes' counts with its share and the issue-slot floor,
    both without the hidden units the count takes as conditional (lower
    bounds).  The row's bound_ms stays the one-thread step's, the function's
    own work."""
    lay = fp.policy_universal_layout(kernel, n)
    out = {"design": lay["design"], "lanes": lay["lanes"], "blocks": lay["blocks"]}
    wide = "/8" if lay["lanes"] == 8 else ""
    info = LANE_KERNELS.get(key.replace(kernel, f"{kernel}_lanes{wide}", 1))
    if lay["lanes"] > 1 and info is not None:
        i_ms = bound_ms(env_steps, info["ops"], nbytes, list(info["ops"]))[0]
        out.update(registers=info["registers"], ops_per_lane_step=info["per_lane"],
                   issue_ops_per_step=info["ops"], issue_bound_ms=i_ms,
                   issue_bound_share=i_ms / ms, **floor_fields(env_steps, info["insns"], ms))
    return out


def run_policy_universal(dev, card, ops):
    """Slice 9, the universal policy-in-the-loop recorder
    (csrc/fused_<family>_policy.cu, one kernel per family): each family's
    kernel against its plain version on every id (and joint heads), the
    recorded actions replayed through the buffer recorder, the alignment
    identity, then the main path counted from zero (fused PPO on every id,
    the two learning checks of the JAX package, 'auto' on the PMSM recorder)
    and the timings.  Returns the six kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import torch_ppo_learn

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_record as frec
    from gym_electric_motor_tpu_torch.ops.fused_rollout import family_of
    from gym_electric_motor_tpu_torch.parallel import (init_actor_critic_params,
                                                       make_fused_ppo_trainer)
    from gym_electric_motor_tpu_torch.parallel import sharded as tsh

    rng = np.random.default_rng(SEED)
    H = H_PPO
    names = fp.UNIVERSAL_KERNELS
    worst = dict.fromkeys(names, 0.0)
    share = dict.fromkeys(names, 1.0)
    timed = {}

    def build(env_id, n, steps, joint=False, env=None, hidden=H, draws=rng):
        env = env or gt.make_functional(env_id, device=dev)
        roll = fp.make_fused_policy_record_universal(env, steps, n, hidden=hidden,
                                                     joint_heads=joint)
        w, ls = pu_weights(torch, draws, roll.policy, hidden, dev)
        planes = fp.fused_policy_init_planes(env, n, device=dev)
        return env, roll, w, ls, planes

    def compare(env_id, n, steps, joint=False, time_row=False, hidden=H):
        """The kernel against its plain version at ``hidden`` units;
        ``time_row``: time both where ``env_id`` is its family's row id."""
        _env, roll, w, ls, planes = build(env_id, n, steps, joint, hidden=hidden)
        pol = roll.policy
        time_it = time_row and PU_ROW_IDS[pol.kernel[:-len("_policy_record")]] == env_id
        args = (pol, SEED, *w, ls, planes, steps)
        if time_it:
            ms, got = cuda_ms(torch, lambda: fp.policy_record_universal(*args), reps=21)
            plain_ms, ref = host_ms(torch, lambda: fp.policy_record_universal_plain(*args))
        else:
            got = fp.policy_record_universal(*args)
            torch.cuda.synchronize()
            ref = fp.policy_record_universal_plain(*args)
        if any(g.dtype != r.dtype or g.shape != (steps, n // 128, 128)
               for g, r in zip(got, ref)):
            raise AssertionError(f"{env_id}: the kernel's signals differ in type or shape")
        angle = [nm == "eps" for nm in roll.signals]
        m, err = env_match(torch, got, ref, angle, n)
        mean_k, mean_p = float(got[-2].double().mean()), float(ref[-2].double().mean())
        rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
        share[pol.kernel] = min(share[pol.kernel], m)
        worst[pol.kernel] = max(worst[pol.kernel], err)
        row = {"max_abs_err": err, "match_share": m, "mean_reward": mean_k,
               "mean_reward_rel_err": rel, "reset_share": float(got[-1].double().mean())}
        if m < 0.999 or rel > 1e-4:
            raise AssertionError(f"{env_id} {pol.kernel}: {m:.5f} of envs match (need 0.999), "
                                 f"mean reward rel err {rel:.2e} (need 1e-4), max abs err {err}")
        if time_it:
            b_ms, b_by = bound_ms(n * steps, pu_ops(ops, pol.kernel, H), pu_bytes(pol, n, steps, H))
            timed[pol.kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     timed_on=env_id)
        return row

    # ---- 38. the kernel against its plain version: every id, joint heads, deep
    n, steps = PU_COMPARE
    rows = {}
    for env_id in gt.ENV_IDS:
        rows[env_id] = compare(env_id, n, steps, time_row=True)
    for env_id in PU_JOINT_IDS:
        rows[env_id + "/joint"] = compare(env_id, n, steps, joint=True)
    emit({"phase": "policy_universal_kernels", "envs": n, "steps": steps, "hidden": H,
          "ids": rows})
    n, steps = PU_DEEP
    deep = {env_id: compare(env_id, n, steps) for env_id in PU_DEEP_IDS}
    emit({"phase": "policy_universal_kernels_deep", "envs": n, "steps": steps, "hidden": H,
          "ids": deep})
    # the main path's own shape and width (phase 41): every id, and the joint heads
    n, steps = PU_MAIN
    main_rows = {env_id: compare(env_id, n, steps, hidden=H_PU_MAIN) for env_id in gt.ENV_IDS}
    for env_id in PU_JOINT_IDS:
        main_rows[env_id + "/joint"] = compare(env_id, n, steps, joint=True, hidden=H_PU_MAIN)
    emit({"phase": "policy_universal_kernels_main_shape", "envs": n, "steps": steps,
          "hidden": H_PU_MAIN, "ids": main_rows})
    # the recorders on lane groups in the design their width rule takes at
    # PPO's width against their one-thread design
    # (what a full card runs), bit for bit:
    # the plain version rounds tanhf and expf otherwise, so the rule above
    # holds it to the plain version and this to the one-thread kernel.  Its
    # weights come from a generator of their own, so that the later phases
    # draw the same weights as without this check
    n, steps = PU_COMPARE
    designs = {}
    design_draws = np.random.default_rng(SEED)
    for env_id, joint, kw in PU_DESIGN_IDS:
        env = gt.make_functional(env_id, device=dev, **kw)
        _env, roll, w, ls, planes = build(env_id, n, steps, joint, env=env, draws=design_draws)
        pol = roll.policy
        got = fp._policy_design_launch(pol, SEED, *w, ls, planes, steps, n)
        one = fp._policy_design_launch(pol, SEED, *w, ls, planes, steps, n, one_thread=True)
        torch.cuda.synchronize()
        m, err = bit_match(torch, got, one, n)
        designs[env_id + ("/joint" if joint else "") + ("/psi_s 1.2" if kw else "")] = {
            "layout": fp.policy_universal_layout(pol.kernel, n), "max_abs_err": err,
            "match_share": m}
        if m != 1.0 or err != 0.0:
            raise AssertionError(f"{env_id}: {pol.kernel}'s design differs from its one-thread "
                                 f"design in {1.0 - m:.5f} of envs (max abs err {err})")
        del got, one
    emit({"phase": "policy_universal_dc_designs", "envs": n, "steps": steps, "hidden": H,
          "ids": designs})

    # ---- 39. the recorded actions replayed through the buffer recorder ------
    # (tests/test_fused_policy_universal.py:89-125, :205-236): the states
    # of every env agree with the policy kernel's up to its first reset
    # (buffer mode has none), rtol 1e-4 / atol 2e-3, angles modulo 2 pi; at
    # the JAX test's depth and with its zero biases, so that a continuous
    # env keeps steps before its first reset
    n, steps = PU_REPLAY
    replay = {}
    for env_id in PU_REPLAY_IDS:
        env, roll, w, ls, planes = build(env_id, n, steps)
        w[1].zero_()
        w[3].zero_()
        out = roll(SEED, *w, *((ls,) if roll.cont else ()), *planes)
        acts = [out[an] for an in roll.act_names]
        if roll.cont:
            pol = roll.policy
            acts = [m + h * torch.tanh(raw) for m, h, raw in zip(pol.mid, pol.half, acts)]
        buf = acts[0] if len(acts) == 1 else torch.stack(acts, 1).contiguous()
        rep = frec.make_fused_record_rollout(env, steps, n, action_mode="buffer")(*planes, buf)
        done = out["done"].reshape(steps, n)
        valid = (torch.cumsum(done, 0) == 0).reshape(steps, n // 128, 128)
        worst_rep = 0.0
        for nm in roll.state_names:
            x, y = out[nm], rep[nm]
            d = angle_err(torch, x, y) if nm == "eps" else (x - y).abs()
            bad = ((d > 2e-3 + 1e-4 * y.abs()) | ~torch.isfinite(y)) & valid
            if bool(bad.any()):
                raise AssertionError(f"{env_id}: buffer replay of {nm} off in {int(bad.sum())} "
                                     f"env-steps (max {float(d[valid].max()):.3e})")
            worst_rep = max(worst_rep, float(d[valid].max()))
        replay[env_id] = {"max_abs_err": worst_rep,
                          "share_compared": float(valid.float().mean())}
        if replay[env_id]["share_compared"] < 0.05:
            raise AssertionError(f"{env_id}: too few env-steps before a reset to replay")
    emit({"phase": "policy_universal_replay", "envs": n, "steps": steps, "ids": replay})

    # ---- 40. alignment: |E[log pi(a|s)] + E[H]| < 0.03 on the rebuilt observation
    n, steps = PU_COMPARE
    align = {}
    for env_id in PU_ALIGN_IDS:
        env, roll, w, ls, planes = build(env_id, n, steps)
        out = roll(SEED, *w, *((ls,) if roll.cont else ()), *planes)

        def tn(x):
            return x.reshape(steps, n)

        prev = {nm: torch.cat([planes[i].reshape(1, -1), tn(out[nm])[:-1]])
                for i, nm in enumerate(roll.state_names)}
        obs = fp.policy_obs_host(roll, prev, {nm: tn(out[nm]) for nm in roll.ref_names})
        with torch.no_grad():
            h = torch.tanh(obs @ w[0].reshape(roll.obs_dim, H) + w[1])
            logits = h @ w[2].reshape(H, roll.n_out) + w[3]
            act = torch.stack([tn(out[an]) for an in roll.act_names], dim=-1)
            lp, ent = tsh.heads_logp_ent(logits, act, roll.act_ns, ls)
        e_lp, e_h = float(lp.double().mean()), float(ent.double().mean())
        align[env_id] = {"E_logp": e_lp, "E_entropy": e_h, "identity": e_lp + e_h}
        if not abs(e_lp + e_h) < 0.03:
            raise AssertionError(f"{env_id}: |E[log pi] + E[H]| = {abs(e_lp + e_h):.4f} "
                                 "(need < 0.03)")
    emit({"phase": "policy_universal_alignment", "envs": n, "steps": steps, "ids": align})

    # ---- 41. the main path, counted from zero: PPO on every id, the two
    # learning checks with their timed iterations, 'auto' on the PMSM recorder
    plain_calls = {"n": 0}
    plain_fns = {nm: getattr(fp, nm) for nm in ("policy_record_universal_plain",
                                                "policy_record_plain")}

    def counting(fn):
        def wrapped(*args, **kw):
            plain_calls["n"] += 1
            return fn(*args, **kw)
        return wrapped

    for nm, fn in plain_fns.items():
        setattr(fp, nm, counting(fn))
    fp.reset_launches()
    try:
        all_ids = {}
        for env_id in gt.ENV_IDS:
            env = gt.make_functional(env_id, device=dev)
            before = dict(fp.LAUNCHES)
            init_opt, train = make_fused_ppo_trainer(env, **PU_ALL_IDS_PPO)
            pol = train.roll.policy
            model = init_actor_critic_params(SEED, pol.obs_dim, pol.n_out,
                                             PU_ALL_IDS_PPO["hidden"], device=dev,
                                             n_cont=fp.policy_n_cont(env))
            p0 = [p.detach().clone() for p in model.parameters()]
            planes = fp.fused_policy_init_planes(env, PU_ALL_IDS_PPO["n_envs"], device=dev)
            model, _opt, planes, rs = train(model, init_opt(model), planes, SEED, 1)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in fp.LAUNCHES.items() if v != before[k]}
            ok = (delta == {pol.kernel: 1} and bool(torch.isfinite(rs).all())
                  and all(bool(torch.isfinite(x).all()) for x in planes)
                  and all(not torch.equal(p.detach(), q) for p, q in zip(model.parameters(), p0)))
            all_ids[env_id] = {"launches": delta, "mean_reward": float(rs[0]), "ok": ok}
            if not ok:
                raise AssertionError(f"{env_id}: one PPO iteration gave {all_ids[env_id]}")
        emit({"phase": "policy_universal_ppo_all_ids", "envs": PU_ALL_IDS_PPO["n_envs"],
              "horizon": PU_ALL_IDS_PPO["horizon"], "hidden": PU_ALL_IDS_PPO["hidden"],
              "ids": all_ids})

        learned = {}
        for env_id, cfg in torch_ppo_learn.UNIVERSAL_CHECKS.items():
            res = torch_ppo_learn.learn_universal(dev, env_id, log=lambda d: None, **cfg)
            model, opt, planes, train = res.pop("trainer")
            events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                      for _ in range(PU_SPLIT_ITERS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, (e0, e1, e2) in enumerate(events):
                e0.record()
                out = train.collect(model, planes, 10_000 + i)
                e1.record()
                planes, _mean_r = train.ppo_update(model, opt, out, planes, 10_000 + i)
                e2.record()
            torch.cuda.synchronize()
            res.update(
                iter_ms_host=1e3 * (time.perf_counter() - t0) / PU_SPLIT_ITERS,
                collect_ms_median=float(np.median([a.elapsed_time(b) for a, b, _ in events])),
                update_ms_median=float(np.median([b.elapsed_time(c) for _, b, c in events])),
                limits=cfg)
            learned[env_id] = res
            emit({"phase": "policy_universal_learn", "card": card, **res})
            if not res["ok"]:
                raise AssertionError(f"{env_id}: PPO through the universal recorder did not "
                                     f"learn: {res}")

        env_sf = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=SF)
        before = dict(fp.LAUNCHES)
        init_opt, train = make_fused_ppo_trainer(env_sf, **PPO)
        model = init_actor_critic_params(SEED, 7, 8, H_PPO, device=dev)
        planes = tuple(torch.zeros((PPO["n_envs"] // 128, 128), device=dev) for _ in range(3))
        train(model, init_opt(model), planes, SEED, 1)
        torch.cuda.synchronize()
        auto_pmsm = {k: v - before[k] for k, v in fp.LAUNCHES.items() if v != before[k]}
        if auto_pmsm != {"policy_record": 1} or getattr(train.roll, "policy", None) is not None:
            raise AssertionError(f"'auto' on Finite-CC-PMSM-v0 with the state filter launched "
                                 f"{auto_pmsm}, expected one policy_record")
    finally:
        for nm, fn in plain_fns.items():
            setattr(fp, nm, fn)
    launches = {k: v for k, v in fp.LAUNCHES.items() if v}
    want = {k: 0 for k in names}
    for env_id in gt.ENV_IDS:
        want[f"{family_of(gt.make_functional(env_id, device=dev))}_policy_record"] += 1
    want["dc_policy_record"] += sum(cfg["iters"] + PU_SPLIT_ITERS
                                    for cfg in torch_ppo_learn.UNIVERSAL_CHECKS.values())
    want["policy_record"] = 1
    emit({"phase": "policy_universal_main_path", "launches": launches, "expected": want,
          "plain_version_calls": plain_calls["n"], "auto_pmsm": auto_pmsm})
    if launches != want or plain_calls["n"]:
        raise AssertionError(f"the universal PPO main path launched {launches} (expected "
                             f"{want}) and called a plain version {plain_calls['n']} times")

    # ---- 42. timings: PPO's shape and the bench width; beside the PMSM recorder
    timings = {}
    for env_id, joint, key in PU_TIMED:
        for n_t, steps_t in PU_TIMED_SHAPES:
            _env, roll, w, ls, planes = build(env_id, n_t, steps_t, joint)
            pol = roll.policy
            ms, out = cuda_ms(torch, lambda: fp.policy_record_universal(pol, SEED, *w, ls, planes,
                                                                        steps_t), reps=EVAL_REPS)
            b_ms, b_by = bound_ms(n_t * steps_t, pu_ops(ops, key, H),
                                  pu_bytes(pol, n_t, steps_t, H))
            row = timings[f"{env_id}{'/joint' if joint else ''}/{n_t}x{steps_t}"] = {
                "ms": ms, "env_steps_per_s": n_t * steps_t / (ms / 1e3), "bound_ms": b_ms,
                "bound_by": b_by, "bound_share": b_ms / ms,
                "reset_share": float(out[-1].double().mean()),
                "finite": all(bool(torch.isfinite(x.float()).all()) for x in out)}
            row.update(pu_design_fields(fp, pol.kernel, key, n_t, n_t * steps_t,
                                        pu_bytes(pol, n_t, steps_t, H), ms))
            del out
    n_t, steps_t = PU_TIMED_SHAPES[1]
    env_sf = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=SF)
    _env, roll, w, ls, planes = build("Finite-CC-PMSM-v0", n_t, steps_t, env=env_sf)
    pol = roll.policy
    consts = fp.PolicyConsts(env_sf)
    w7 = rl_weights(torch, rng, dev, 7, H, 0.5, 0.1)
    z = planes[0]
    u_ms, out = cuda_ms(torch, lambda: fp.policy_record_universal(pol, SEED, *w, None, planes,
                                                                  steps_t), reps=EVAL_REPS)
    p_ms, out2 = cuda_ms(torch, lambda: fp.policy_record(consts, SEED, *w7, z, z, z, steps_t),
                         reps=EVAL_REPS)
    timings["Finite-CC-PMSM-v0/universal_vs_policy_record"] = {
        "envs": n_t, "steps": steps_t, "universal_ms": u_ms, "policy_record_ms": p_ms,
        "ratio": u_ms / p_ms,
        "universal_bound_ms": bound_ms(n_t * steps_t, pu_ops(ops, "sync_policy_record", H),
                                       pu_bytes(pol, n_t, steps_t, H))[0],
        "policy_record_bound_ms": bound_ms(n_t * steps_t, ops["policy_record"],
                                           12 * n_t + 32 * n_t * steps_t
                                           + 4 * fp.n_policy_params(7, H_PPO))[0]}
    del out, out2
    emit({"phase": "policy_universal_timings", "card": card, "hidden": H, "timings": timings})
    bad = [k for k, v in timings.items() if not v.get("finite", True)]
    if bad:
        raise AssertionError(f"universal recorder timings produced non-finite values: {bad}")

    # ---- kernels line rows -----------------------------------------------------
    line = []
    n, steps = PU_COMPARE
    for name in names:
        t = timed[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"gym_electric_motor_tpu_torch/csrc/fused_{name[:-len('_policy_record')]}"
                      "_policy.cu",
            "replaces": "gym_electric_motor_tpu/ops/pallas_policy.py:1256",
            "launches": launches[name], "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "envs": n, "steps": steps, "hidden": H,
            "timed_on": t["timed_on"], "match_share": share[name]})
    return line


CONTROL_COMPARE = 64          # steps of each kernel-vs-plain comparison (phase 43)
CONTROL_DEEP = 1024           # and again on one id per kernel
CONTROL_LOOP_ENVS = 128       # phase 44's closed loops
T_FOC_LOOP = 400              # tests/test_pallas_rollout.py:376-415
T_CASCADE_LOOP = 600          # against control_environment (host-bound: about 10 ms a step)
T_DC_CONVERGE = 4000          # tests/test_pallas_rollout.py:790-812
T_CONTROL_GENERAL = 200
FOC_ID = "Cont-CC-PMSM-v0"
DC_CASCADE_IDS = ("Cont-SC-PermExDc-v0", "Cont-SC-SeriesDc-v0", "Cont-SC-ShuntDc-v0")
SRM_CASCADE_TIMED = ("Finite-SC-SRM-v0", "Finite-TC-SRM-v0")
CONTROL_REFS = {"foc": [("i_sd", -0.1), ("i_sq", 0.3)], "dc": [("omega", 0.5)],
                "CC": [("i_a", 0.2), ("i_b", 0.3), ("i_c", 0.1)], "TC": [("torque", 0.3)],
                "SC": [("omega", 0.4)]}


def control_bytes(kind, c, n):
    """Bytes a controller-in-the-loop kernel must move for ``n`` envs: the
    state planes it reads (the FOC's two reference planes in const mode
    only) and every output once (the reference rows n_ref each, the
    integrators)."""
    if kind == "foc":
        return 4 * n * ((3 if c.wiener else 5) + 5 + 8)
    n_state, n_ref = c.c.n_state, c.c.n_ref
    n_int = 2 if kind == "dc" else 1
    return 4 * n * (n_state + n_state + 2 + 4 * n_ref + n_int)


def run_control(dev, card, ops):
    """Slice 10, the classical controllers and the three controller-in-the-
    loop kernels (csrc/fused_foc.cu, csrc/fused_dc_cascade.cu,
    csrc/fused_srm_cascade.cu): each kernel against its plain version, then
    the main path, its launches counted from zero: the closed loops through
    GemController.make and the three builders against control_environment,
    and the timings.  Returns the three kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.controllers import GemController
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)
    mods = {"foc_rollout": fs, "dc_cascade_rollout": dcf, "srm_cascade_rollout": srf}

    def env_of(env_id, refs=None, **kw):
        if refs:
            kw["reference_generator"] = rg.ReferenceSpec([rg.ConstReference(n, v)
                                                          for n, v in refs])
        return gt.make_functional(env_id, device=dev, **kw)

    def planes(bounds, r=R):
        return [torch.as_tensor(rng.uniform(lo, hi, (r, 128)).astype(np.float32), device=dev)
                for lo, hi in bounds]

    def case(kind, env_id, mode, kw=None):
        """(kernel name, consts, kernel call, plain call) of one instance."""
        refs = None if mode == "wiener" else CONTROL_REFS[
            kind if kind != "srm" else env_id.split("-")[1]]
        env = env_of(env_id, refs, **(kw or {}))
        ctrl = GemController.make(env, env_id)
        if kind == "foc":
            c = fs.FocConsts(env, ctrl, mode)
            start = planes([(-50, 50), (-50, 50), (0, 2 * np.pi), (-0.3, 0.3), (-0.3, 0.3)])
            return ("foc_rollout", c, lambda t: fs.foc_rollout(c, SEED, *start, t),
                    lambda t: fs.foc_rollout_plain(c, SEED, *start, t))
        if kind == "dc":
            c = dcf.DcCascadeConsts(env, ctrl)
            start = planes([(0, 100)] + [(-5, 5)] * (c.c.n_state - 1))
            return ("dc_cascade_rollout", c, lambda t: dcf.dc_cascade_rollout(c, SEED, start, t),
                    lambda t: dcf.dc_cascade_rollout_plain(c, SEED, start, t))
        c = srf.SrmCascadeConsts(env, ctrl)
        start = planes(([(0, 100)] if c.c.mech else []) + [(0, 22)] * 3 + [(-np.pi, np.pi)])
        return ("srm_cascade_rollout", c, lambda t: srf.srm_cascade_rollout(c, SEED, start, t),
                lambda t: srf.srm_cascade_rollout_plain(c, SEED, start, t))

    def reward_index(name, c):
        return 3 if name == "foc_rollout" else c.c.n_state

    # ---- 43. each kernel against its plain version, every instance -------
    # (const: every env at rtol 1e-5 / atol 1e-4; Wiener: the random-mode
    # rule, 99.9% of envs and the mean reward to 1e-4 relative; after the
    # loop, the FOC and both cascades bit for bit in every env)
    cases = ([("foc", FOC_ID, None)] + [("dc", i, None) for i in DC_CASCADE_IDS]
             + [("srm", i, None) for i in gt.SRM_ENV_IDS]
             + [("srm", i, SRM_SAT) for i in SRM_SAT_IDS])
    timed_on = {"foc_rollout": FOC_ID, "dc_cascade_rollout": DC_CASCADE_IDS[0],
                "srm_cascade_rollout": SRM_CASCADE_TIMED[0]}
    worst = dict.fromkeys(mods, 0.0)
    share = dict.fromkeys(mods, 1.0)
    timed, rows = {}, []
    for kind, env_id, kw in cases:
        for mode in ("const", "wiener"):
            name, c, kern, plain = case(kind, env_id, mode, kw)
            if mode == "wiener" and env_id == timed_on[name] and not kw:
                ms, got = cuda_ms(torch, lambda: kern(CONTROL_COMPARE), reps=21)
                plain_ms, ref = host_ms(torch, lambda: plain(CONTROL_COMPARE))
                b_ms, b_by = bound_ms(N * CONTROL_COMPARE, ops[name], control_bytes(kind, c, N))
                timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            else:
                got = kern(CONTROL_COMPARE)
                torch.cuda.synchronize()
                ref = plain(CONTROL_COMPARE)
            label = f"{env_id}{' psi_s 1.2' if kw else ''} {mode}"
            if mode == "const":
                err = check_buffer(torch, f"{label} {name}", got, ref, [False] * len(got))
                worst[name] = max(worst[name], err)
                rows.append({"case": label, "kernel": name, "max_abs_err": err})
            else:
                r_idx = reward_index(name, c)
                m, err = env_match(torch, got, ref, [False] * len(got), N)
                mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
                rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
                worst[name], share[name] = max(worst[name], err), min(share[name], m)
                rows.append({"case": label, "kernel": name, "max_abs_err": err, "match_share": m,
                             "mean_reward_rel_err": rel})
                if m < 0.999 or rel > 1e-4:
                    raise AssertionError(f"{label} {name}: {m:.5f} of envs match (need 0.999), "
                                         f"mean reward rel err {rel:.2e}")
            del got, ref
    deep = {}
    for kind, env_id in (("foc", FOC_ID), ("dc", DC_CASCADE_IDS[0]),
                         ("srm", SRM_CASCADE_TIMED[0])):
        name, c, kern, plain = case(kind, env_id, "wiener")
        got = kern(CONTROL_DEEP)
        torch.cuda.synchronize()
        ref = plain(CONTROL_DEEP)
        m, err = env_match(torch, got, ref, [False] * len(got), N)
        r_idx = reward_index(name, c)
        mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
        rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
        worst[name], share[name] = max(worst[name], err), min(share[name], m)
        deep[f"{env_id} {name}"] = {"max_abs_err": err, "match_share": m,
                                    "mean_reward_rel_err": rel}
        if m < 0.999 or rel > 1e-4:
            raise AssertionError(f"{env_id} {name} at {CONTROL_DEEP} steps: {m:.5f} of envs "
                                 f"match, mean reward rel err {rel:.2e}")
        del got, ref
    emit({"phase": "control_kernels", "envs": N, "steps": CONTROL_COMPARE, "results": rows,
          "deep_steps": CONTROL_DEEP, "deep": deep, "timed": timed})
    # the FOC and the cascades equal their plain versions bit for bit, every
    # env
    for name in ("foc_rollout", "srm_cascade_rollout", "dc_cascade_rollout"):
        if worst[name] != 0.0 or share[name] != 1.0:
            raise AssertionError(f"{name}: max abs err {worst[name]}, {share[name]} of envs "
                                 f"match (need 0 and 1)")

    # ---- 44.-45. the main path: counts from zero --------------------------
    for mod in mods.values():
        mod.reset_launches()
    n_loop = CONTROL_LOOP_ENVS
    z1 = torch.zeros((n_loop // 128, 128), device=dev)

    # 44. the closed loops against control_environment, const references
    # (tests/test_pallas_rollout.py:376-415, :790-812, tests/test_srm.py:
    # 207-233), and their convergence
    loops = {}
    env = env_of(FOC_ID, CONTROL_REFS["foc"])
    ctrl = GemController.make(env, FOC_ID)
    set_d, set_q = (v for _n, v in CONTROL_REFS["foc"])
    isd, isq, _eps, rew, terms, *_ = fr.make_fused_foc_rollout(env, ctrl, T_FOC_LOOP, n_loop,
                                                               ref_mode="const")(
        SEED, z1, z1, z1, torch.full_like(z1, set_d), torch.full_like(z1, set_q))
    out = ctrl.control_environment(env, T_FOC_LOOP)
    names, lim = env.state_names, np.asarray(env.physical_system.limits)
    isd_lim, isq_lim = float(lim[names.index("i_sd")]), float(lim[names.index("i_sq")])
    isd_x = float(out["states"][-1, names.index("i_sd")]) * isd_lim
    isq_x = float(out["states"][-1, names.index("i_sq")]) * isq_lim
    k_isd, k_isq = float(isd[0, 0]), float(isq[0, 0])
    loops[FOC_ID] = {
        "steps": T_FOC_LOOP, "i_sd": k_isd, "i_sq": k_isq, "i_sd_env": isd_x, "i_sq_env": isq_x,
        "mean_reward": float(rew.double().sum()) / (n_loop * T_FOC_LOOP),
        "mean_reward_env": float(out["rewards"].double().mean()),
        "terminations": float(terms.sum())}
    ok = (abs(k_isd - isd_x) <= 1e-3 + 1e-5 * abs(isd_x)
          and abs(k_isq - isq_x) <= 1e-3 + 1e-5 * abs(isq_x)
          and abs(k_isd - set_d * isd_lim) <= 0.05 and abs(k_isq - set_q * isq_lim) <= 0.05
          and abs(loops[FOC_ID]["mean_reward"] - loops[FOC_ID]["mean_reward_env"])
          <= 1e-6 + 1e-4 * abs(loops[FOC_ID]["mean_reward_env"])
          and loops[FOC_ID]["terminations"] == 0.0)
    if not ok:
        raise AssertionError(f"the FOC closed loop: {loops[FOC_ID]}")
    for env_id in DC_CASCADE_IDS:
        env = env_of(env_id, CONTROL_REFS["dc"])
        ctrl = GemController.make(env, env_id)
        n_state = fr.fused_state_arity(env)
        w_lim = float(np.asarray(env.physical_system.limits)[env.state_names.index("omega")])
        row = {}
        if env_id == DC_CASCADE_IDS[0]:
            k = fr.make_fused_dc_cascade_rollout(env, ctrl, T_CASCADE_LOOP, n_loop)(
                SEED, *[z1] * n_state)
            res = ctrl.control_environment(env, T_CASCADE_LOOP)
            omega_x = float(res["states"][-1, env.state_names.index("omega")]) * w_lim
            row.update(steps=T_CASCADE_LOOP, omega=float(k[0][0, 0]), omega_env=omega_x,
                       mean_reward=float(k[n_state].double().sum()) / (n_loop * T_CASCADE_LOOP),
                       mean_reward_env=float(res["rewards"].double().mean()),
                       terminations=float(k[n_state + 1].sum()))
            if not (abs(row["omega"] - omega_x) <= 1e-2 + 1e-5 * abs(omega_x)
                    and abs(row["mean_reward"] - row["mean_reward_env"])
                    <= 1e-6 + 1e-4 * abs(row["mean_reward_env"]) and row["terminations"] == 0):
                raise AssertionError(f"{env_id} cascade against control_environment: {row}")
        k = fr.make_fused_dc_cascade_rollout(env, ctrl, T_DC_CONVERGE, n_loop)(
            SEED, *[z1] * n_state)
        row.update(converge_steps=T_DC_CONVERGE, omega_final=float(k[0][0, 0]),
                   target=0.5 * w_lim, converge_terminations=float(k[n_state + 1].sum()))
        if not (abs(row["omega_final"] - 0.5 * w_lim) <= 2e-3 * 0.5 * w_lim
                and row["converge_terminations"] == 0):
            raise AssertionError(f"{env_id} cascade did not converge: {row}")
        loops[env_id] = row
    for env_id in SRM_CASCADE_TIMED:
        env = env_of(env_id, CONTROL_REFS[env_id.split("-")[1]])
        ctrl = GemController.make(env, env_id)
        n_state = fr.fused_state_arity(env)
        k = fr.make_fused_srm_cascade_rollout(env, ctrl, T_CASCADE_LOOP, n_loop)(
            SEED, *[z1] * n_state)
        oc = ctrl.control_environment(env, T_CASCADE_LOOP)
        row = {"steps": T_CASCADE_LOOP,
               "mean_reward": float(k[n_state].double().mean()) / T_CASCADE_LOOP,
               "mean_reward_env": float(oc["rewards"].double().mean()),
               "terminations": float(k[n_state + 1].sum()),
               "terminations_env": float(oc["terminations"].sum())}
        loops[env_id] = row
        if not (abs(row["mean_reward"] - row["mean_reward_env"]) <= 2e-5
                and row["terminations"] == 0 and row["terminations_env"] == 0):
            raise AssertionError(f"{env_id} cascade against control_environment: {row}")
    emit({"phase": "control_loops", "envs": n_loop, "loops": loops})

    # 45. timings at the bench width, each kernel in one call with the
    # open-loop universal kernel on the same id (the catalog's Wiener
    # references; the FOC and the DC cascade on their rings), the DC
    # cascade's ring also alone on its other two motors, and the general
    # path's control_environment
    timings = {}
    pairs = (("foc_rollout", FOC_ID, "sync_rollout_random"),
             ("dc_cascade_rollout", DC_CASCADE_IDS[0], "dc_rollout_random"),
             ("dc_cascade_rollout", DC_CASCADE_IDS[1], None),
             ("dc_cascade_rollout", DC_CASCADE_IDS[2], None),
             ("srm_cascade_rollout", SRM_CASCADE_TIMED[0], "srm_rollout_random"),
             ("srm_cascade_rollout", SRM_CASCADE_TIMED[1], "srm_rollout_random"))
    for name, env_id, open_name in pairs:
        env = env_of(env_id)
        ctrl = GemController.make(env, env_id)
        n_state = fr.fused_state_arity(env)
        z = [torch.zeros((R, 128), device=dev) for _ in range(n_state)]
        if name == "foc_rollout":
            roll = fr.make_fused_foc_rollout(env, ctrl, T_ROLLOUT, N)
            c, r_idx = roll.consts, 3
        elif name == "dc_cascade_rollout":
            roll = fr.make_fused_dc_cascade_rollout(env, ctrl, T_ROLLOUT, N)
            c, r_idx = roll.consts, n_state
        else:
            roll = fr.make_fused_srm_cascade_rollout(env, ctrl, T_ROLLOUT, N)
            c, r_idx = roll.consts, n_state
        key = "" if env_id == timed_on[name] else "/" + env_id
        nbytes = control_bytes(name.split("_")[0], c, N)
        k_ms, out = cuda_ms(torch, lambda: roll(SEED, *z), reps=SYNC_REPS)
        b_ms, b_by = bound_ms(N * T_ROLLOUT, ops[name + key], nbytes)
        row = {name: {"steps": T_ROLLOUT, "ms": k_ms,
                      "env_steps_per_s": N * T_ROLLOUT / (k_ms / 1e3),
                      "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
                      "ops_per_step": ops[name + key],
                      "mean_reward": float(out[r_idx].double().sum()) / (N * T_ROLLOUT),
                      "reset_share": float(out[r_idx + 1].double().sum()) / (N * T_ROLLOUT),
                      "finite": all(bool(torch.isfinite(x).all()) for x in out)}}
        if name != "srm_cascade_rollout":
            # the design the launch takes: on the ring, both roles' issue
            # bound and the issue-slot floor beside the one-thread bound
            layout = (fs.foc_ring_layout(c) if name == "foc_rollout"
                      else dcf.dc_cascade_ring_layout(c))
            row[name].update(ring_fields(layout, name + "_ws" + key, name + key, name + key,
                                         N * T_ROLLOUT, nbytes, k_ms))
        if open_name:
            open_roll = fr.make_fused_rollout(env, T_ROLLOUT, N)
            o_ms, o_out = cuda_ms(torch, lambda: open_roll(SEED, *z), reps=SYNC_REPS)
            row[open_name] = {"steps": T_ROLLOUT, "ms": o_ms,
                              "env_steps_per_s": N * T_ROLLOUT / (o_ms / 1e3),
                              "ops_per_step": ops[f"{open_name}/{env_id}"],
                              "reset_share": float(o_out[n_state + 1].double().sum())
                              / (N * T_ROLLOUT)}
            row["closed_over_open"] = k_ms / o_ms
            del o_out
        timings[env_id] = row
        if not row[name]["finite"]:
            raise AssertionError(f"{env_id}: the {T_ROLLOUT}-step {name} produced non-finite "
                                 "values")
        del out
    env = env_of(DC_CASCADE_IDS[0])
    ctrl = GemController.make(env, DC_CASCADE_IDS[0])
    ctrl.control_environment(env, 5, seed=SEED, n_envs=N)  # warm-up
    g_ms, res = host_ms(torch, lambda: ctrl.control_environment(env, T_CONTROL_GENERAL,
                                                                seed=SEED, n_envs=N))
    timings["control_environment/" + DC_CASCADE_IDS[0]] = {
        "steps": T_CONTROL_GENERAL, "ms": g_ms,
        "env_steps_per_s": N * T_CONTROL_GENERAL / (g_ms / 1e3),
        "mean_reward": float(res["rewards"].double().mean()),
        "reset_share": float(res["terminations"].double().mean())}
    if not bool(torch.isfinite(res["states"]).all()):
        raise AssertionError("control_environment produced non-finite states")
    del res
    launches = {name: mod.LAUNCHES[name] for name, mod in mods.items()}
    emit({"phase": "control_timings", "card": card, "envs": N, "timings": timings,
          "launches": launches})
    per_timing = 2 + SYNC_REPS
    want = {"foc_rollout": 1 + per_timing,
            "dc_cascade_rollout": 1 + len(DC_CASCADE_IDS) * (1 + per_timing),
            "srm_cascade_rollout": len(SRM_CASCADE_TIMED) * (1 + per_timing)}
    if launches != want:
        raise AssertionError(f"the controller kernels on the main path launched {launches}, "
                             f"expected {want}")

    # ---- kernels line rows -----------------------------------------------
    replaces = {"foc_rollout": "gym_electric_motor_tpu/ops/pallas_sync.py:1339",
                "dc_cascade_rollout": "gym_electric_motor_tpu/ops/pallas_dc.py:1455",
                "srm_cascade_rollout": "gym_electric_motor_tpu/ops/pallas_srm.py:859"}
    sources = {"foc_rollout": "fused_foc", "dc_cascade_rollout": "fused_dc_cascade",
               "srm_cascade_rollout": "fused_srm_cascade"}
    line = []
    for name in mods:
        t, m = timed[name], timings[timed_on[name]][name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"gym_electric_motor_tpu_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "envs": N, "steps": CONTROL_COMPARE, "timed_on": timed_on[name],
            "match_share": share[name], "main_steps": T_ROLLOUT, "main_ms": m["ms"],
            "main_bound_ms": m["bound_ms"],
            **{"main_" + k: m[k] for k in ("design", "ring", "registers", "issue_bound_ms",
                                           "issue_floor_ms") if k in m}})
    return line


SPEC_COMPARE = 64             # steps of each kernel-vs-plain comparison (phase 46)
PERMEX = "Finite-CC-PermExDc-v0"
SPEC_SERIES, SPEC_SHUNT = "Cont-SC-SeriesDc-v0", "Cont-SC-ShuntDc-v0"
# the builders' ids (bench.py:790-825), each with its start bounds and
# action buffer
SPEC_IDS = {PERMEX: ([(-100, 100)], "4qc"),
            SPEC_SERIES: ([(0, 100), (-5, 5)], "duty"),
            SPEC_SHUNT: ([(0, 100), (-5, 5), (-5, 5)], "duty"),
            "Cont-TC-SCIM-v0": ([(-8, 8)] * 2 + [(-1, 1)] * 2, "duty3"),
            "Finite-CC-EESM-v0": ([(-8, 8)] * 3 + [(0, 2 * math.pi)], "b6_4qc"),
            "Cont-CC-DFIM-v0": ([(-10, 10)] * 2 + [(-1.5, 1.5)] * 2 + [(0, 2 * math.pi)],
                                "duty6")}
# kernel -> (the id it is compared and timed on, the TPU kernel it replaces)
SPEC_KERNELS = {
    "permex_rollout_random": (PERMEX, "pallas_dc.py:206"),
    "permex_rollout_buffer": (PERMEX, "pallas_dc.py:192"),
    "permex_record_random": (PERMEX, "pallas_dc.py:349"),
    "permex_record_buffer": (PERMEX, "pallas_dc.py:275"),
    "dc_sc_rollout_random": (SPEC_SHUNT, "pallas_dc.py:577"),
    "dc_sc_rollout_buffer": (SPEC_SHUNT, "pallas_dc.py:560"),
    "scim_rollout_random": ("Cont-TC-SCIM-v0", "pallas_induction.py:235"),
    "scim_rollout_buffer": ("Cont-TC-SCIM-v0", "pallas_induction.py:220"),
    "eesm_cc_rollout_random": ("Finite-CC-EESM-v0", "pallas_eesm.py:280"),
    "eesm_cc_rollout_buffer": ("Finite-CC-EESM-v0", "pallas_eesm.py:264"),
    "dfim_cc_rollout_random": ("Cont-CC-DFIM-v0", "pallas_dfim.py:287"),
    "dfim_cc_rollout_buffer": ("Cont-CC-DFIM-v0", "pallas_dfim.py:271"),
}
SPEC_SOURCES = {"permex": "fused_permex", "dc_sc": "fused_dc_sc", "scim": "fused_scim_tc",
                "eesm_cc": "fused_eesm_cc", "dfim_cc": "fused_dfim_cc"}
# the random kernel timed on each id, the universal kernel beside it and the
# key of the universal kernel's counted instance
SPEC_UNIVERSAL = {
    PERMEX: ("permex_rollout_random", "dc_rollout_random",
             "dc_rollout_random/Finite-CC-PermExDc-v0"),
    SPEC_SERIES: ("dc_sc_rollout_random", "dc_rollout_random",
                  "dc_rollout_random/Cont-SC-PermExDc-v0"),
    SPEC_SHUNT: ("dc_sc_rollout_random", "dc_rollout_random", "dc_rollout_random"),
    "Cont-TC-SCIM-v0": ("scim_rollout_random", "induction_rollout_random",
                        "induction_rollout_random/Cont-TC-SCIM-v0"),
    "Finite-CC-EESM-v0": ("eesm_cc_rollout_random", "eesm_rollout_random",
                          "eesm_rollout_random/Finite-CC-EESM-v0"),
    "Cont-CC-DFIM-v0": ("dfim_cc_rollout_random", "dfim_rollout_random",
                        "dfim_rollout_random/Cont-CC-DFIM-v0")}

# the specialised random rollouts and the PermExDc recorder, which run on a
# ring (ring_pipe.cuh), by the module of gym_electric_motor_tpu_torch.ops
# and its function that gives the ring's layout
SPEC_RINGS = {"permex_rollout_random": ("fused_dc", "permex_ring_layout"),
              "permex_record_random": ("fused_dc", "permex_record_ring_layout"),
              "dc_sc_rollout_random": ("fused_dc", "dc_sc_ring_layout"),
              "eesm_cc_rollout_random": ("fused_eesm", "eesm_cc_ring_layout"),
              "dfim_cc_rollout_random": ("fused_dfim", "dfim_cc_ring_layout"),
              "scim_rollout_random": ("fused_induction", "scim_tc_ring_layout")}


def spec_ring_fields(name, key, env_steps, nbytes, ms):
    """``ring_fields`` of a specialised random rollout or recorder on a
    ring (phases 46 and 48): ``key`` is its one-thread entry in
    tools/sass_ops.py's STEP_INSTANCES (the function's own work), and the
    ``_ws`` entry beside it counts both roles."""
    import importlib

    module, layout_fn = SPEC_RINGS[name]
    mod = importlib.import_module(f"gym_electric_motor_tpu_torch.ops.{module}")
    layout = getattr(mod, layout_fn)()
    return ring_fields(layout, key.replace("_random", "_ws", 1), key, key, env_steps, nbytes, ms)


def tensor_bytes(xs):
    """Bytes of the tensors among ``xs`` (nested in lists and tuples)."""
    if isinstance(xs, (list, tuple)):
        return sum(tensor_bytes(x) for x in xs)
    return xs.numel() * xs.element_size() if hasattr(xs, "numel") else 0


def run_specialised(dev, card, ops):
    """Slice 11, the specialised builders (csrc/fused_permex.cu,
    csrc/fused_dc_sc.cu, csrc/fused_scim_tc.cu, csrc/fused_eesm_cc.cu,
    csrc/fused_dfim_cc.cu): each kernel against its plain version, then the
    main path, its launches counted from zero: the builders of
    ops/fused_rollout.py in buffer mode against the universal buffer
    kernels, and in random mode timed beside the universal kernel on the
    same id.  Returns the twelve kernels' rows of the kernels line."""
    import numpy as np
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch.ops import fused_dc as fd
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_dfim as ff
    from gym_electric_motor_tpu_torch.ops import fused_eesm as fe
    from gym_electric_motor_tpu_torch.ops import fused_induction as fi
    from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
    from gym_electric_motor_tpu_torch.ops.fused_record import make_fused_record_rollout

    N, R = N_ENVS, N_ENVS // 128
    rng = np.random.default_rng(SEED)
    mods = {name: mod for mod in (fd, fi, fe, ff) for name in mod.KERNELS}
    consts = {PERMEX: fd.PermexConsts, SPEC_SERIES: fd.DcScConsts, SPEC_SHUNT: fd.DcScConsts,
              "Cont-TC-SCIM-v0": fi.ScimConsts, "Finite-CC-EESM-v0": fe.EesmCcConsts,
              "Cont-CC-DFIM-v0": ff.DfimCcConsts}
    builders = {PERMEX: fr.make_fused_permex_rollout, SPEC_SERIES: fr.make_fused_dc_sc_rollout,
                SPEC_SHUNT: fr.make_fused_dc_sc_rollout,
                "Cont-TC-SCIM-v0": fr.make_fused_scim_rollout,
                "Finite-CC-EESM-v0": fr.make_fused_eesm_rollout,
                "Cont-CC-DFIM-v0": fr.make_fused_dfim_rollout}
    # the angle's state plane, where there is one
    angle_at = {"Finite-CC-EESM-v0": 3, "Cont-CC-DFIM-v0": 4}

    def start_of(env_id):
        return [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
                for lo, hi in SPEC_IDS[env_id][0]]

    def actions_of(env_id, steps):
        kind = SPEC_IDS[env_id][1]
        if kind == "4qc":
            a = rng.integers(0, 4, (steps, R, 128)).astype(np.int32)
        elif kind == "b6_4qc":
            a = np.stack([rng.integers(0, 8, (steps, R, 128)),
                          rng.integers(0, 4, (steps, R, 128))], axis=1).astype(np.int32)
        else:
            n_ch = {"duty": (), "duty3": (3,), "duty6": (6,)}[kind]
            a = rng.uniform(-1, 1, (steps,) + n_ch + (R, 128)).astype(np.float32)
        return torch.as_tensor(a, device=dev)

    def reward_index(name, n_state):
        if name == "permex_record_random":
            return 3
        return 1 if name == "permex_rollout_random" else n_state

    def as_tuple(x):
        return (x,) if isinstance(x, torch.Tensor) else tuple(x)

    # ---- 46. each kernel against its plain version -----------------------
    # (bit for bit, both modes: error 0 in every env; -fmad=false makes the
    # kernels round as their plain versions do)
    cases = [(name, env_id, SPEC_COMPARE) for name, (env_id, _r) in SPEC_KERNELS.items()]
    cases += [("dc_sc_rollout_random", SPEC_SERIES, SPEC_COMPARE),
              ("dc_sc_rollout_buffer", SPEC_SERIES, SPEC_COMPARE),
              ("permex_record_random", PERMEX, T_RECORD)]
    worst = dict.fromkeys(SPEC_KERNELS, 0.0)
    share = dict.fromkeys(SPEC_KERNELS, 1.0)
    timed, rows = {}, []
    for name, env_id, steps in cases:
        mod = mods[name]
        c = consts[env_id](gt.make_functional(env_id, device=dev))
        start = start_of(env_id)
        state = start[0] if name.startswith("permex") else start
        random = "random" in name
        args = (SEED, state, steps) if random else (state, actions_of(env_id, steps))

        def kern():
            return getattr(mod, name)(c, *args)

        def plain():
            return getattr(mod, name + "_plain")(c, *args)

        if env_id == SPEC_KERNELS[name][0] and steps == SPEC_COMPARE:
            ms, got = cuda_ms(torch, kern, reps=21)
            plain_ms, ref = host_ms(torch, plain)
            b_ms, b_by = bound_ms(N * steps, ops[name], tensor_bytes(args) + tensor_bytes(got))
            timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            if name in SPEC_RINGS:
                timed[name].update(spec_ring_fields(name, name, N * steps,
                                                    tensor_bytes(args) + tensor_bytes(got), ms))
        else:
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
        got, ref = as_tuple(got), as_tuple(ref)
        n_state = len(start)
        is_angle = [j == angle_at.get(env_id) for j in range(len(got))]
        row = {"case": f"{env_id} {name}", "steps": steps}
        if random:
            m, err = env_match(torch, got, ref, is_angle, N)
            r_idx = reward_index(name, n_state)
            mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
            rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
            row.update(max_abs_err=err, match_share=m, mean_reward_rel_err=rel)
            share[name] = min(share[name], m)
        else:
            err = check_buffer(torch, f"{env_id} {name}", got, ref, is_angle)
            m = 1.0
            row.update(max_abs_err=err, match_share=m)
        if m < 1.0 or err != 0.0:
            raise AssertionError(f"{env_id} {name}: {m:.5f} of envs match, max abs err {err:.3e} "
                                 "(the specialised kernels equal their plain versions bit for "
                                 "bit)")
        worst[name] = max(worst[name], err)
        rows.append(row)
        del got, ref
    emit({"phase": "specialised_kernels", "envs": N, "steps": SPEC_COMPARE,
          "record_steps": T_RECORD, "results": rows, "timed": timed})

    # ---- 47.-48. the main path: counts from zero ---------------------------
    for mod in (fd, fi, fe, ff):
        mod.reset_launches()

    # 47. each builder's buffer mode against the universal buffer kernels,
    # reached through the dispatch, on the same id and buffer
    against = {}
    for env_id in SPEC_IDS:
        env = gt.make_functional(env_id, device=dev)
        start = start_of(env_id)
        acts = actions_of(env_id, SPEC_COMPARE)
        universal = fr.make_fused_rollout(env, SPEC_COMPARE, N, action_mode="buffer")(*start, acts)
        got = builders[env_id](env, SPEC_COMPARE, N, action_mode="buffer")(*start, acts)
        is_angle = [j == angle_at.get(env_id) for j in range(len(start))]
        row = {"rollout": check_buffer(torch, f"{env_id} buffer vs universal", as_tuple(got),
                                       universal, is_angle)}
        if env_id == PERMEX:
            rec = fr.make_fused_permex_record_rollout(env, SPEC_COMPARE, N,
                                                      action_mode="buffer")(start[0], acts)
            u_rec = make_fused_record_rollout(env, SPEC_COMPARE, N, action_mode="buffer")(
                start[0], acts)["i"]
            row["record"] = check_buffer(torch, f"{env_id} record buffer vs universal", (rec,),
                                         (u_rec,), [False])
        against[env_id] = row
    emit({"phase": "specialised_buffer", "envs": N, "steps": SPEC_COMPARE,
          "max_abs_err_vs_universal": against})

    # 48. the random builders at the bench width, each in one call with the
    # universal kernel on the same id; the recorder at its 1024 steps
    timings = {}
    for env_id in SPEC_IDS:
        env = gt.make_functional(env_id, device=dev)
        n_state = len(SPEC_IDS[env_id][0])
        z = [torch.zeros((R, 128), device=dev) for _ in range(n_state)]
        name, u_name, u_key = SPEC_UNIVERSAL[env_id]
        roll = builders[env_id](env, T_ROLLOUT, N)
        c = roll.consts
        k_ms, out = cuda_ms(torch, lambda: roll(SEED, *z), reps=SYNC_REPS)
        u_roll = fr.make_fused_rollout(env, T_ROLLOUT, N)
        u_ms, u_out = cuda_ms(torch, lambda: u_roll(SEED, *z), reps=SYNC_REPS)
        key = name if env_id == SPEC_KERNELS[name][0] else f"{name}/{env_id}"
        b_ms, b_by = bound_ms(N * T_ROLLOUT, ops[key], tensor_bytes(z) + tensor_bytes(out))
        r_idx = reward_index(name, n_state)
        reward, terms, rv, rk, rl, rs = out[r_idx:r_idx + 6]
        f = c.f
        if env_id == "Finite-CC-EESM-v0":
            lo = torch.tensor([w[0] for w in c.windows], device=dev).repeat_interleave(N)
            hi = torch.tensor([w[1] for w in c.windows], device=dev).repeat_interleave(N)
            in_window = bool(((rv.reshape(-1) >= lo) & (rv.reshape(-1) <= hi)).all())
        else:
            lo = 0.0 if env_id in (SPEC_SERIES, SPEC_SHUNT) else -f["margin"]
            in_window = bool(((rv >= lo) & (rv <= f["margin"])).all())
        sig_lo, sig_hi = 10.0 ** f["sig_base"], 10.0 ** (f["sig_base"] + f["sig_span"])
        mean_k = float(reward.double().sum()) / (N * T_ROLLOUT)
        mean_u = float(u_out[n_state].double().sum()) / (N * T_ROLLOUT)
        checks = {
            "finite": all(bool(torch.isfinite(x).all()) for x in out),
            "ref_in_window": in_window,
            "lengths": bool(((rl >= 500) & (rl < 2000) & (rk >= 1) & (rk <= rl)).all()),
            "sigma": bool(((rs >= sig_lo * 0.999) & (rs <= sig_hi * 1.001)).all()),
            # the same process in distribution (the JAX suite's kernel-vs-env
            # bound, tests/test_pallas_rollout.py:230)
            "mean_reward_vs_universal": abs(mean_k - mean_u) < 0.08,
        }
        if env_id in angle_at:
            eps = out[angle_at[env_id]]
            checks["eps_in_range"] = bool(((eps >= 0) & (eps <= 2 * math.pi)).all())
        design = (spec_ring_fields(name, key, N * T_ROLLOUT, tensor_bytes(z) + tensor_bytes(out),
                                   k_ms) if name in SPEC_RINGS else {})
        timings[env_id] = {
            name: {"steps": T_ROLLOUT, "ms": k_ms, "env_steps_per_s": N * T_ROLLOUT / (k_ms / 1e3),
                   "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
                   "ops_per_step": ops[key], "mean_reward": mean_k,
                   "reset_share": float(terms.double().sum()) / (N * T_ROLLOUT), **design},
            u_name: {"steps": T_ROLLOUT, "ms": u_ms, "env_steps_per_s": N * T_ROLLOUT / (u_ms / 1e3),
                     "ops_per_step": ops[u_key], "mean_reward": mean_u,
                     "reset_share": float(u_out[n_state + 1].double().sum()) / (N * T_ROLLOUT)},
            "specialised_over_universal": k_ms / u_ms, "checks": checks}
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise AssertionError(f"{env_id} {name}: output checks failed: {failed}")
        del out, u_out
    env = gt.make_functional(PERMEX, device=dev)
    z = torch.zeros((R, 128), device=dev)
    rec = fr.make_fused_permex_record_rollout(env, T_RECORD, N)
    k_ms, out = cuda_ms(torch, lambda: rec(SEED, z), reps=SYNC_REPS)
    u_rec = make_fused_record_rollout(env, T_RECORD, N)
    u_ms, u_out = cuda_ms(torch, lambda: u_rec(SEED, z), reps=SYNC_REPS)
    nbytes = tensor_bytes(z) + tensor_bytes(out)
    b_ms, b_by = bound_ms(N * T_RECORD, ops["permex_record_random"], nbytes)
    i, ref, act, reward, done = out
    margin = rec.consts.f["margin"]
    checks = {"finite": all(bool(torch.isfinite(x.float()).all()) for x in out),
              "ref_in_window": bool((ref.abs() <= margin * 1.001).all()),
              "actions": bool(((act >= 0) & (act <= 3)).all()),
              "reset_zeroes": bool((i[done > 0.5] == 0).all()),
              "mean_reward_vs_universal": abs(float(reward.double().mean())
                                              - float(u_out["reward"].double().mean())) < 0.08}
    timings[PERMEX + " record"] = {
        "permex_record_random": {"steps": T_RECORD, "ms": k_ms, "bytes_written": nbytes - 4 * N,
                                 "GB_per_s": (nbytes - 4 * N) / (k_ms / 1e3) / 1e9,
                                 "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
                                 "ops_per_step": ops["permex_record_random"],
                                 "mean_reward": float(reward.double().mean()),
                                 "reset_share": float(done.double().mean()),
                                 **spec_ring_fields("permex_record_random", "permex_record_random",
                                                    N * T_RECORD, nbytes, k_ms)},
        "dc_record_random": {"steps": T_RECORD, "ms": u_ms,
                             "ops_per_step": ops["dc_record_random/Finite-CC-PermExDc-v0"],
                             "reset_share": float(u_out["done"].double().mean()),
                             "design": dcf.dc_record_ring_layout(u_rec.consts)["design"]},
        "specialised_over_universal": k_ms / u_ms, "checks": checks}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"permex_record_random: output checks failed: {failed}")
    del out, u_out
    launches = {name: mods[name].LAUNCHES[name] for name in SPEC_KERNELS}
    emit({"phase": "specialised_timings", "card": card, "envs": N, "timings": timings,
          "launches": launches})
    per_timing = 2 + SYNC_REPS
    want = {name: (1 if "buffer" in name else per_timing) for name in SPEC_KERNELS}
    want.update(dc_sc_rollout_buffer=2, dc_sc_rollout_random=2 * per_timing)
    if launches != want:
        raise AssertionError(f"the specialised kernels on the main path launched {launches}, "
                             f"expected {want}")

    # ---- kernels line rows -----------------------------------------------
    line = []
    for name, (env_id, replaces) in SPEC_KERNELS.items():
        t = timed[name]
        prefix = name.rsplit("_rollout", 1)[0].rsplit("_record", 1)[0]
        row = {"name": name, "route": "cuda",
               "source": f"gym_electric_motor_tpu_torch/csrc/{SPEC_SOURCES[prefix]}.cu",
               "replaces": f"gym_electric_motor_tpu/ops/{replaces}", "launches": launches[name],
               "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
               "envs": N, "steps": SPEC_COMPARE, "timed_on": env_id,
               "match_share": share[name]}
        if "random" in name:
            main = timings[PERMEX + " record" if name == "permex_record_random" else env_id]
            u_name = "dc_record_random" if name == "permex_record_random" else \
                SPEC_UNIVERSAL[env_id][1]
            m = main[name]
            row.update(main_steps=m["steps"], main_ms=m["ms"], main_bound_ms=m["bound_ms"],
                       universal=u_name, universal_ms=main[u_name]["ms"],
                       specialised_over_universal=main["specialised_over_universal"])
            if name in SPEC_RINGS:
                row.update({"main_" + k: m[k] for k in ("design", "ring", "registers",
                                                        "issue_bound_ms", "issue_floor_ms")
                            if k in m})
        line.append(row)
    return line


# the kernels redesigned for Hopper after their port, by the redesign
# (PERF.md, section 5, names when; the SRM cascade's lane groups and the
# SRM recorder's ring on the finite ids were slower and not kept)
REDESIGNED = {"srm_rollout_random": "lane groups at constant speed",
              "srm_cascade_rollout": "lane groups, tried and not kept",
              "dc_rollout_random": "ring", "eesm_rollout_random": "ring",
              "policy_record": "lane groups below a full card",
              "induction_rollout_random": "ring", "dfim_rollout_random": "ring",
              "sync_rollout_random": "ring", "policy_rollout": "ring, layer 1 in registers",
              "dc_sc_rollout_random": "ring", "eesm_cc_rollout_random": "ring",
              "dc_cascade_rollout": "ring with Wiener references",
              "foc_rollout": "ring with Wiener references", "dfim_cc_rollout_random": "ring",
              "scim_rollout_random": "ring",
              "reinforce_rollout": "role split, traces in registers",
              "pmsm_rollout_random": "ring", "permex_rollout_random": "ring",
              "pmsm_record_random": "ring with Wiener references",
              "permex_record_random": "ring with Wiener references",
              "dc_policy_record": "lane groups below a full card",
              "srm_record_random": "ring on the continuous ids, on the finite ones tried and "
                                   "not kept",
              "dc_record_random": "ring with Wiener references",
              "eesm_record_random": "ring with Wiener references",
              "sync_record_random": "ring with Wiener references",
              "induction_record_random": "ring with Wiener references",
              "dfim_record_random": "ring with Wiener references",
              "sync_policy_record": "lane groups at PPO's width",
              "eesm_policy_record": "lane groups at PPO's width",
              "srm_policy_record": "lane groups at PPO's width",
              "dfim_policy_record": "lane groups at PPO's width",
              "induction_policy_record": "lane groups at PPO's width"}


def redesign_order(line):
    """The kernels by launches x gap, largest first: the main path's
    launches times the time a launch takes above its bound, at the main
    path's shape where the row has one (its timed id's), else at the
    comparison shape.  Every launch counts at that shape, so the score is
    an approximation of the time the path loses to each kernel.  Each entry
    names the redesign its kernel has had (REDESIGNED), or null."""
    out = []
    for r in line:
        main = r.get("main_ms") is not None and r.get("main_bound_ms") is not None
        ms, b_ms = (r["main_ms"], r["main_bound_ms"]) if main else (r["ms"], r["bound_ms"])
        out.append({"name": r["name"], "launches": r["launches"], "ms": ms, "bound_ms": b_ms,
                    "gap_ms": ms - b_ms, "launches_x_gap_ms": r["launches"] * (ms - b_ms),
                    "shape": "main" if main else "compare",
                    "redesigned": REDESIGNED.get(r["name"])})
    return sorted(out, key=lambda x: -x["launches_x_gap_ms"])


def main():
    root = Path(__file__).resolve().parent
    if not (root / "gym_electric_motor_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke.py: gym_electric_motor_tpu_torch/ is not next to this script")
    sys.path[:0] = [str(root), str(root / "tools")]
    import torch

    # ---- 1. card ---------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    line, ops = run(dev, card)
    seconds = {"slice_1": lap()}
    line += run_rl(dev, card, ops)
    seconds["slice_2"] = lap()
    line += run_sync(dev, card, ops)
    seconds["slice_3"] = lap()
    line += run_dc(dev, card, ops)
    seconds["slice_4"] = lap()
    line += run_induction(dev, card, ops)
    seconds["slice_5"] = lap()
    line += run_eesm(dev, card, ops)
    seconds["slice_6"] = lap()
    line += run_dfim(dev, card, ops)
    seconds["slice_7"] = lap()
    line += run_srm(dev, card, ops)
    seconds["slice_8"] = lap()
    line += run_policy_universal(dev, card, ops)
    seconds["slice_9"] = lap()
    line += run_control(dev, card, ops)
    seconds["slice_10"] = lap()
    line += run_specialised(dev, card, ops)
    seconds["slice_11"] = lap()
    emit({"phase": "elapsed", "seconds": seconds, "total": clock[-1] - clock[0]})

    # ---- 49. the order of the next redesigns, kernels line, card, result ----
    emit({"phase": "redesign_order", "ranking": redesign_order(line)})
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
