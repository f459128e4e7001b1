"""PLAIN vector format: one value per line, the length inferred.

Port of ``lis_tpu/io/plain.py`` (reference: LIS_FMT_PLAIN,
include/lis.h:56, reader lis_input_vector_plain,
src/system/lis_input.c:402).
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import host


def read_vector_plain(path: str, device=None) -> torch.Tensor:
    """Read a PLAIN vector file onto ``device`` (None: the default
    device): every whitespace-separated value in order."""
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(tok) for tok in line.split())
    return torch.from_numpy(np.array(vals)).to(resolve_device(device))


def write_vector_plain(path: str, vec):
    """Write a PLAIN vector file, one value a line (lis_output_vector_plain,
    lis_output.c:180)."""
    with open(path, "w") as f:
        for x in host(vec):
            f.write(f"{x:.16e}\n")
