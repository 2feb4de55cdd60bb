"""repro_torch.learn — train transfer-tuning policies in the simulator (the
port of ``repro.learn``).

The pipeline:

1. **Capture** teacher rollouts through the engine's ``observe=True`` hook
   (:func:`teacher_dataset`) — every controller tick of an ME/EEMT/EETT
   run becomes a (normalized observation, action delta) pair.
2. **Train** with behavior cloning (:func:`bc_train`) and optionally
   refine with REINFORCE on energy·delay (:func:`pg_train`), both with
   ``torch.autograd`` on ``repro_torch.optim.adamw``, from explicit
   ``torch.Generator``\\ s (:func:`seed_everything`).
3. **Deploy** as a :class:`LearnedController` —
   ``api.make_controller("learned", params=...)`` — which flows through
   ``Scenario.run/sweep`` and Experiments like any built-in controller
   (on a card, through the tick kernel); params checkpoint via
   :func:`save_policy` / :func:`load_policy` in the JAX package's layout.
4. **Score** against the heuristics on the fig2-style grid
   (:func:`evaluate`).

Capture and PG rollouts run the eager tick loop (the engine's
``reference`` executor) on the given device; every entry point takes
``device=`` (default ``"cuda"``).
"""
from .controller import (LearnedController, canonical_params,  # noqa: F401
                         load_policy, params_digest, save_policy)
from .evaluate import (default_rivals, evaluate,  # noqa: F401
                       evaluation_experiment, vs_teacher)
from .policy import (HEADS, N_CLASSES, N_FEATURES, N_HEADS,  # noqa: F401
                     PolicyConfig, action_classes, apply_action,
                     apply_policy, config_from_params, featurize,
                     init_policy)
from .rollout import (make_policy_rollout, n_ctrl_ticks,  # noqa: F401
                      run_observed, teacher_dataset)
from .train import (PGConfig, bc_train, pg_train,  # noqa: F401
                    seed_everything)
