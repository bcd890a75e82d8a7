"""Grid policy shared by the f32 attention kernels: K1's f32 path
(``propagation_attention``) and K2's forward (``propagation_attention_train``).

A block of either forward owns ``Q_BLOCK`` q rows and a column width that
``column_width`` picks from a cost model, one block an SM. A block's
``fixed`` work (whatever its width) is counted in columns of its product.
The two values the wrappers pass are not derived from the kernels' code:
``FORWARD_FIXED`` = 160 is fitted so that K2's forward takes the widths that
measured fastest on an H100 (run D5 in PERF.md: 512 columns at 18,721 x 2,145
and 256 at 2,145 x 2,145); ``FC_FIXED`` = 64 is an estimate of K1's fc block
splitting its rows of the PV result, not fitted to a measurement.
"""

from __future__ import annotations

import functools

import torch

Q_BLOCK = 64          # q rows a block of the f32 forward
WIDTHS = (512, 256, 128)   # the column widths a block may own
FORWARD_FIXED = 160   # K2's forward block: its scores, exp, divide and mask
FC_FIXED = 64         # K1's fc block


def column_width(row_blocks: int, dv: int, sms: int, fixed: int) -> int:
    """The columns (512, 256 or 128, dividing d_v) a block of ``Q_BLOCK`` rows
    owns: the width that minimises waves x (columns + ``fixed``), one block an
    SM. Narrower where few rows leave SMs idle."""
    ceil = lambda a, b: -(-a // b)
    widths = [c for c in WIDTHS if dv % c == 0]
    return min(widths, key=lambda c: (ceil(row_blocks * (dv // c), sms) * (c + fixed), -c))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int | None) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count
