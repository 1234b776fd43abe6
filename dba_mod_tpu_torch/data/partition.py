"""Client data partitioning with reference-RNG parity.

`sample_dirichlet_indices` reproduces image_helper.py:82-110 *numerically*:
same `random.shuffle` on each class's index pool, same
`np.random.dirichlet([alpha]*P)` draw per class, same int(round(·)) prefix
consumption of the pool — so with the same seeds the resulting partition is
identical to the reference's, which keeps accuracy curves comparable
(SURVEY §7.2.7).
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List

import numpy as np


def build_class_indices(labels: np.ndarray) -> Dict[int, List[int]]:
    """Label → list of sample indices, in dataset order
    (image_helper.py:72-80)."""
    out: Dict[int, List[int]] = defaultdict(list)
    for ind, label in enumerate(labels):
        out[int(label)].append(ind)
    return dict(out)


def sample_dirichlet_indices(labels: np.ndarray, no_participants: int,
                             alpha: float,
                             py_rng: random.Random | None = None,
                             np_rng: np.random.RandomState | None = None
                             ) -> Dict[int, List[int]]:
    """Non-IID Dirichlet partition (image_helper.py:82-110). Consumes RNG in
    the reference's order: per class, shuffle the pool then draw one Dirichlet
    vector over participants. `class_size` is len(class 0)'s pool, used as the
    scale for every class (reference quirk, :92)."""
    py_rng = py_rng or random
    np_rng = np_rng or np.random
    classes = build_class_indices(labels)
    class_size = len(classes[0])
    no_classes = len(classes)
    per_participant: Dict[int, List[int]] = defaultdict(list)
    for n in range(no_classes):
        pool = classes[n]
        py_rng.shuffle(pool)
        probs = class_size * np_rng.dirichlet(
            np.array(no_participants * [alpha]))
        for user in range(no_participants):
            no_imgs = int(round(probs[user]))
            take = min(len(pool), no_imgs)
            per_participant[user].extend(pool[:take])
            pool = pool[take:]
    return dict(per_participant)


def equal_split_indices(num_samples: int, no_participants: int,
                        py_rng: random.Random | None = None
                        ) -> Dict[int, List[int]]:
    """Equal random split (image_helper.py:231-236, :265-280): one global
    shuffle, then contiguous chunks of len(dataset)/P."""
    py_rng = py_rng or random
    all_range = list(range(num_samples))
    py_rng.shuffle(all_range)
    data_len = num_samples // no_participants
    return {pos: all_range[pos * data_len:(pos + 1) * data_len]
            for pos in range(no_participants)}


def poison_test_indices(test_labels: np.ndarray,
                        poison_label_swap: int) -> np.ndarray:
    """Indices of test samples whose true label != the swap target — the
    poisoned-eval set drops images already of the target class
    (image_helper.py:148-172)."""
    return np.nonzero(test_labels != poison_label_swap)[0].astype(np.int32)
