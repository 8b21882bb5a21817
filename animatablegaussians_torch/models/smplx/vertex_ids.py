"""Mesh vertex indices of the extra OpenPose/MSCOCO landmark joints: a copy
of ``animatablegaussians_tpu/models/smplx/vertex_ids.py``.

Data constants from the public SMPL family model topology (same tables the
reference ships, ref: smplx/vertex_ids.py) — vertex ids of the nose, eyes,
ears, finger tips and feet keypoints appended to the LBS joints by
``extra_joints_indices`` (ref: smplx/vertex_joint_selector.py).
"""

VERTEX_IDS = {
    "smplh": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133,
        "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
        "lpinky": 2673,
        "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
        "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
        "rpinky": 8022,
        "lthumb": 5361, "lindex": 4933, "lmiddle": 5058, "lring": 5169,
        "lpinky": 5286,
        "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
        "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
    "mano": {
        "thumb": 744, "index": 320, "middle": 443, "ring": 554, "pinky": 671,
    },
}

_TIP_NAMES = ("thumb", "index", "middle", "ring", "pinky")


def extra_joints_indices(vertex_ids, use_hands: bool = True,
                         use_feet_keypoints: bool = True):
    """Vertex indices of the extra landmark joints, in the reference's
    append order: 5 face keypoints, 6 feet keypoints, 10 finger tips
    (ref: smplx/vertex_joint_selector.py VertexJointSelector.__init__)."""
    import numpy as np

    idxs = [vertex_ids[k] for k in ("nose", "reye", "leye", "rear", "lear")]
    if use_feet_keypoints:
        idxs += [vertex_ids[k] for k in ("LBigToe", "LSmallToe", "LHeel",
                                         "RBigToe", "RSmallToe", "RHeel")]
    if use_hands:
        for hand in ("l", "r"):
            idxs += [vertex_ids[hand + t] for t in _TIP_NAMES]
    return np.asarray(idxs, dtype=np.int64)
