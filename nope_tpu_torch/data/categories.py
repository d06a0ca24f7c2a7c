"""ShapeNet taxonomy: synset-id ↔ category mapping and the NOPE splits
(the port's copy of ``nope_tpu/data/categories.py``).

Data equivalent of ``src/utils/shapeNet_id2cat_v2.json`` +
``src/utils/shapeNet_utils.py``: 13 training categories, 10 unseen test
categories (the "novel categories" protocol of the paper).
"""

from __future__ import annotations

SHAPENET_ID2CAT: dict[str, str] = {
    "02691156": "airplane", "02747177": "trash bin", "02773838": "bag",
    "02801938": "basket", "02808440": "bathtub", "02818832": "bed",
    "02828884": "bench", "02843684": "birdhouse", "02871439": "bookshelf",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02942699": "camera", "02946921": "can",
    "02954340": "cap", "02958343": "car", "02992529": "cellphone",
    "03001627": "chair", "03046257": "clock", "03085013": "keyboard",
    "03207941": "dishwasher", "03211117": "display", "03261776": "earphone",
    "03325088": "faucet", "03337140": "file cabinet", "03467517": "guitar",
    "03513137": "helmet", "03593526": "jar", "03624134": "knife",
    "03636649": "lamp", "03642806": "laptop", "03691459": "loudspeaker",
    "03710193": "mailbox", "03759954": "microphone", "03761084": "microwaves",
    "03790512": "motorbike", "03797390": "mug", "03928116": "piano",
    "03938244": "pillow", "03948459": "pistol", "03991062": "flowerpot",
    "04004475": "printer", "04074963": "remote", "04090263": "rifle",
    "04099429": "rocket", "04225987": "skateboard", "04256520": "sofa",
    "04330267": "stove", "04379243": "table", "04401088": "telephone",
    "04460130": "tower", "04468005": "train", "04530566": "watercraft",
    "04554684": "washer",
}

SHAPENET_CAT2ID: dict[str, str] = {v: k for k, v in SHAPENET_ID2CAT.items()}

#: categories seen during training (shapeNet_utils.py:5-19)
TRAIN_CATEGORIES = [
    "airplane", "bench", "cabinet", "car", "chair", "display", "lamp",
    "loudspeaker", "rifle", "sofa", "table", "telephone", "watercraft",
]

#: unseen categories used only for evaluation (shapeNet_utils.py:21-32)
TEST_CATEGORIES = [
    "bottle", "bus", "clock", "dishwasher", "guitar", "mug", "pistol",
    "skateboard", "train", "washer",
]

#: categories with circular symmetry → metric symmetry class 2
#: (shapeNet.py:156-165)
CIRCULAR_SYMMETRY_CATEGORIES = ["bottle"]


def symmetry_class(category: str) -> int:
    return 2 if category in CIRCULAR_SYMMETRY_CATEGORIES else 0
