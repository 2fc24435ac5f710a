"""Koppen-Geiger climate classes: the code table and the majority-vote
classifier over a class-code field (numpy only).

Counterpart of the numpy part of `weatherforecast_stgcn_maml_tpu/data/koppen.py`.
Reading a Koppen NetCDF map (`koppen_code_for_box`) belongs with the ERA5
backend, which the port does not have (`engines/data_source.py`).
"""

from __future__ import annotations

import numpy as np

# Code -> class name. Index 0 is padding.
CODE_TO_CLASS: dict[int, str] = {
    1: "Af", 2: "Am", 3: "Aw", 4: "BSh", 5: "BSk", 6: "BWh", 7: "BWk",
    8: "Cfa", 9: "Cfb", 10: "Cfc", 11: "Csa", 12: "Csb", 13: "Csc",
    14: "Cwa", 15: "Cwb", 16: "Cwc", 17: "Dfa", 18: "Dfb", 19: "Dfc",
    20: "Dfd", 21: "Dsa", 22: "Dsb", 23: "Dsc", 24: "Dsd", 25: "Dwa",
    26: "Dwb", 27: "Dwc", 28: "Dwd", 29: "EF", 30: "ET",
}

NUM_KOPPEN_CLASSES = 31  # 0..30 inclusive; 0 = unknown/padding


def majority_code(class_field: np.ndarray) -> int:
    """Majority Koppen code of a (possibly NaN-holed) class-code field; -1
    when the field holds no valid data."""
    flat = np.asarray(class_field, dtype=np.float64).ravel()
    flat = flat[~np.isnan(flat)].astype(np.int64)
    if flat.size == 0:
        return -1
    codes, counts = np.unique(flat, return_counts=True)
    return int(codes[np.argmax(counts)])


def class_name(code: int) -> str:
    return CODE_TO_CLASS.get(code, "unknown")
