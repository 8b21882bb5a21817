"""Configuration system: a copy of ``animatablegaussians_tpu/config.py``
(numpy and yaml only), so the port never imports the JAX package.

YAML schema is byte-compatible with the reference configs
(ref: config.py:25-31, configs/avatarrex_zzr/avatar.yaml): a nested dict with
``train/test/model`` sections. Unlike the reference's global mutable
``config.opt`` dict, configs here are explicit immutable objects passed down
the call tree.

Also hosts the canonical-pose / fist-pose numeric constants
(ref: config.py:9-19).
"""

from __future__ import annotations

import math
import os
from typing import Any, Mapping

import numpy as np
import yaml

PROJ_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))

# ---------------------------------------------------------------------------
# Canonical SMPL-X pose: A-pose with legs spread +-25 degrees about z.
# Layout of the 75-dim vector: [transl(3), global_orient(3), body_pose(63),
# jaw/extra(6)] (ref: config.py:9-15).
# ---------------------------------------------------------------------------

def canonical_smpl_pose() -> np.ndarray:
    pose = np.zeros(75, dtype=np.float32)
    pose[3 + 3 * 1 + 2] = math.radians(25.0)
    pose[3 + 3 * 2 + 2] = math.radians(-25.0)
    return pose


CANO_SMPL_POSE = canonical_smpl_pose()
CANO_SMPL_TRANSL = CANO_SMPL_POSE[:3]
CANO_SMPL_GLOBAL_ORIENT = CANO_SMPL_POSE[3:6]
CANO_SMPL_BODY_POSE = CANO_SMPL_POSE[6:69]

# Fist hand poses (45-dim axis-angle per hand) used for the `fist` hand mode
# in pose-driven animation (ref: config.py:18-19).
LEFT_HAND_FIST_POSE = np.array([
    0.09001956135034561, 0.1604590266942978, -0.3295670449733734,
    0.12445037066936493, -0.11897698789834976, -1.5051144361495972,
    -0.1194705069065094, -0.16281449794769287, -0.6292539834976196,
    -0.27713727951049805, 0.035170216113328934, -0.5893177390098572,
    -0.20759613811969757, 0.07492011040449142, -1.4485805034637451,
    -0.017797302454710007, -0.12478633224964142, -0.7844052314758301,
    -0.4157009720802307, -0.5140947103500366, -0.2961726784706116,
    -0.7421528100967407, -0.11505582183599472, -0.7972996830940247,
    -0.29345276951789856, -0.18898937106132507, -0.6230823397636414,
    -0.18764786422252655, -0.2696149945259094, -0.5542467832565308,
    -0.47717514634132385, -0.12663133442401886, -1.2747308015823364,
    -0.23940050601959229, -0.1586960405111313, -0.7655659914016724,
    0.8745182156562805, 0.5848557353019714, -0.07204405218362808,
    -0.5052485466003418, 0.1797526329755783, 0.3281439244747162,
    0.5276764035224915, -0.008714836090803146, -0.4373648762702942,
], dtype=np.float32)

RIGHT_HAND_FIST_POSE = np.array([
    0.034751810133457184, -0.12605343759059906, 0.5510415434837341,
    0.19454114139080048, 0.11147838830947876, 1.4676157236099243,
    -0.14799435436725616, 0.17293521761894226, 0.4679432511329651,
    -0.3042353689670563, 0.007868679240345955, 0.8570928573608398,
    -0.1827319711446762, -0.07225851714611053, 1.307037591934204,
    -0.02989627793431282, 0.1208646297454834, 0.7142824530601501,
    -0.3403030335903168, 0.5368582606315613, 0.3839572072029114,
    -0.9722614884376526, 0.17358140647411346, 0.911861002445221,
    -0.29665058851242065, 0.21779759228229523, 0.7269846796989441,
    -0.15343312919139862, 0.3083758056163788, 0.7146623730659485,
    -0.5153037309646606, 0.1721675992012024, 1.2982604503631592,
    -0.2590428292751312, 0.12812566757202148, 0.7502076029777527,
    0.8694817423820496, -0.5263001322746277, 0.06934576481580734,
    -0.4630220830440521, -0.19237111508846283, -0.25436165928840637,
    0.5972414612770081, -0.08250168710947037, 0.5013565421104431,
], dtype=np.float32)


# ---------------------------------------------------------------------------
# Config object
# ---------------------------------------------------------------------------

class Config(Mapping[str, Any]):
    """Read-only view over the YAML dict with .get()/[] access.

    Keeps the exact reference key paths (e.g. ``cfg['train']['data']['data_dir']``)
    so reference YAML files load unchanged.
    """

    def __init__(self, data: dict):
        self._data = dict(data)

    # Mapping protocol -----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        v = self._data[key]
        return Config(v) if isinstance(v, dict) else v

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        v = self._data.get(key, default)
        return Config(v) if isinstance(v, dict) else v

    def to_dict(self) -> dict:
        return dict(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def load_config(path: str) -> Config:
    with open(path, encoding="UTF-8") as f:
        data = yaml.load(f, Loader=yaml.FullLoader)
    return Config(data)
