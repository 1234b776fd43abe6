"""Per-round agent selection — host-side, reference main.py:139-164 parity.

Three modes:
1. random namelist + random adversary: uniform sample of no_models (may pick
   no adversaries at all);
2. random namelist + fixed adversary (the paper's mode): adversaries whose
   poison schedule covers this round are forced in, the rest of the round is
   filled with a uniform sample over benign agents + off-schedule adversaries;
3. fixed namelist: participants_namelist verbatim.

Uses an explicit `random.Random` instead of the reference's module-global
seeded RNG (main.py:36-38) so selection is reproducible independent of other
host-side consumers.
"""
from __future__ import annotations

import random
from typing import Any, List, Tuple

from dba_mod_tpu_torch import config as cfg


def select_agents(params: cfg.Params, epoch: int, participants: List[Any],
                  benign_names: List[Any], rng: random.Random
                  ) -> Tuple[List[Any], List[Any]]:
    """Returns (agent_name_keys, adversarial_name_keys) for one round."""
    agent_name_keys = list(participants)
    adversarial_name_keys: List[Any] = []
    if params["is_random_namelist"]:
        if params["is_random_adversary"]:
            agent_name_keys = rng.sample(participants, params["no_models"])
            adversarial_name_keys = [n for n in agent_name_keys
                                     if n in params.adversary_list]
        else:
            ongoing = list(range(epoch, epoch + params["aggr_epoch_interval"]))
            for idx, adv in enumerate(params.adversary_list):
                sched = params.poison_epochs_for(idx)
                if any(e in sched for e in ongoing):
                    if adv not in adversarial_name_keys:
                        adversarial_name_keys.append(adv)
            nonattacker = [adv for adv in params.adversary_list
                           if adv not in adversarial_name_keys]
            benign_num = params["no_models"] - len(adversarial_name_keys)
            fill = rng.sample(benign_names + nonattacker, benign_num)
            agent_name_keys = adversarial_name_keys + fill
    else:
        if not params["is_random_adversary"]:
            adversarial_name_keys = list(params.adversary_list)
    return agent_name_keys, adversarial_name_keys
