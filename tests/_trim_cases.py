"""Drained blocks for the trimmed combine: ties, non-finite entries, one
valid row, no valid row, twelve rows. Numpy only, so the CPU tests against
``repro`` and the card tests against the plain PyTorch version share
them."""
import numpy as np


def trim_cases():
    rng = np.random.default_rng(3)
    K, D = 4, 33
    rows = rng.normal(size=(K, D)).astype(np.float32)
    ties = np.round(rows * 2) / 2  # many equal values per column
    ties[:, 0] = 1.0
    nonfinite = rows.copy()
    nonfinite[0, 3] = np.inf
    nonfinite[1, 4] = -np.inf
    nonfinite[2, 5] = np.nan
    nonfinite[0, 6] = np.inf
    nonfinite[1, 6] = np.inf
    return {
        "plain": (rows, np.float32([1, 2, 1, 3])),
        "ties": (ties, np.float32([1, 1, 2, 0])),
        "all_invalid": (rows, np.zeros(K, np.float32)),
        "one_valid": (rows, np.float32([0, 0, 2, 0])),
        "nonfinite": (nonfinite, np.float32([1, 1, 1, 1])),
        "nonfinite_two_valid": (nonfinite, np.float32([1, 0, 0, 3])),
        # a drained block of twelve rows
        "twelve_rows": (np.concatenate([nonfinite, ties, rows]),
                        np.float32([1, 2, 0, 1] * 3)),
    }
