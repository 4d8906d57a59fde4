"""Determinism: one seed for Python's and numpy's host generators, as
qflux_tpu/utils/seed.py.  The port's device noise comes from the Trainer's
seeded `torch.Generator`s, which this does not touch."""

from __future__ import annotations

import os
import random

import numpy as np


def seed_everything(seed: int = 1234) -> int:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
