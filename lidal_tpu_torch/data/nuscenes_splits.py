"""Official nuScenes v1.0-trainval scene split, shipped as data.

The reference obtains the 700/150 train/val scene split from the
nuscenes-devkit at runtime (``dataset/nu_dataloader.py:34`` via
``nuscenes.utils.splits.create_splits_scenes``).  The split is a fixed public
constant (devkit ``python-sdk/nuscenes/utils/splits.py``), replicated verbatim
across the 3D-perception ecosystem; shipping it removes the devkit dependency.

Only the 150-name VAL list is stored: the official train list is exactly the
complement within the 850 trainval scenes, so ``train = scenes - OFFICIAL_VAL``
reconstructs it from the dataset's own scene table.  ``load_splits`` sanity-
checks the expected 700/150 shape when given the full trainval scene set and
falls back (with a warning) otherwise.
"""

from __future__ import annotations

# nuscenes-devkit splits.py `val` — 150 scene names (public constant).
OFFICIAL_VAL = frozenset(
    "scene-%04d" % i
    for i in (
        # fmt: off
        3, 12, 13, 14, 15, 16, 17, 18,
        35, 36, 38, 39, 92, 93, 94, 95,
        96, 97, 98, 99, 100, 101, 102, 103,
        104, 105, 106, 107, 108, 109, 110, 221,
        268, 269, 270, 271, 272, 273, 274, 275,
        276, 277, 278, 329, 330, 331, 332, 344,
        345, 346, 519, 520, 521, 522, 523, 524,
        552, 553, 554, 555, 556, 557, 558, 559,
        560, 561, 562, 563, 564, 565, 625, 626,
        627, 629, 630, 632, 633, 634, 635, 636,
        637, 638, 770, 771, 775, 777, 778, 780,
        781, 782, 783, 784, 794, 795, 796, 797,
        798, 799, 800, 802, 904, 905, 906, 907,
        908, 909, 910, 911, 912, 913, 914, 915,
        916, 917, 919, 920, 921, 922, 923, 924,
        925, 926, 927, 928, 929, 930, 931, 962,
        963, 966, 967, 968, 969, 971, 972, 1059,
        1060, 1061, 1062, 1063, 1064, 1065, 1066, 1067,
        1068, 1069, 1070, 1071, 1072, 1073,
        # fmt: on
    )
)

TRAINVAL_SCENES = 850  # v1.0-trainval scene count (700 train + 150 val)


def official_split(scene_names) -> tuple[list, list] | None:
    """(train, val) per the official devkit split, or None when the given
    scene set does not look like v1.0-trainval (e.g. v1.0-mini, synthetic
    test trees) so the caller can fall back."""
    names = list(scene_names)
    val = [s for s in names if s in OFFICIAL_VAL]
    train = [s for s in names if s not in OFFICIAL_VAL]
    if len(names) == TRAINVAL_SCENES:
        # the real trainval table: the constant must carve it exactly 700/150
        assert len(val) == 150 and len(train) == 700, (len(train), len(val))
        return train, val
    if val:  # a subset of trainval (mini-style trees keep official membership)
        return train, val
    return None
