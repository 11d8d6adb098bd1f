"""Dict-of-arrays helpers for result aggregation (the port's copy of the
part of ``disco_tpu/core/miscx.py`` the corpus driver needs; the JAX module's
YAML and plotting helpers stay there).  Host numpy."""
from __future__ import annotations

import numpy as np


def find_unmatched_dim(arr1, arr2):
    """Indices of axes where the two (equal-ndim) arrays' shapes differ
    (misc_utils.py:19-27)."""
    return (np.array(arr1.shape) - np.array(arr2.shape) != 0).nonzero()


def concatenate_dicts(dict_list):
    """Concatenate same-keyed dicts of arrays; each key is concatenated along
    its first mismatching axis, or axis 0 when shapes fully match
    (misc_utils.py:30-46)."""
    out = dict_list[0].copy()
    for other in dict_list[1:]:
        for k in out:
            mism = np.array(find_unmatched_dim(out[k], other[k]))
            axis = int(mism[0][0]) if mism.size else 0
            out[k] = np.concatenate((out[k], other[k]), axis=axis)
    return out
