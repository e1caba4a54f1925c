"""The packed B-operand layout of the int8 tensor-core kernels
(``csrc/int8_mma.cuh``): a (K, N) int8 kernel laid out in the order in which
the threads of a warp read their ``mma.sync.m16n8k32`` B fragments.

With g = lane // 4 and t = lane % 4, fragment b[0] of an n8 tile holds
column g, rows 4t .. 4t + 3 of a 32-row k-step, and b[1] rows 16 + 4t ..
16 + 4t + 3. The packed array is int8 [N / 64][K / 32][4][32][16]: for pass
p (64 output channels), k-step s, pair q (n-tiles 2q and 2q + 1 of the pass)
and lane L, the 16 bytes are b[0], b[1] of n-tile 2q, then b[0], b[1] of
n-tile 2q + 1. So a warp reads one pair of one k-step as 512 consecutive
bytes, and the k-steps of one pass are one contiguous run.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

PASS_N = 64
STEP_K = 32


def pack_b_operand(w_kn: Tensor) -> Tensor:
    """(K, N) int8, K a multiple of 32 and N of 64 -> the packed layout,
    (N / 64, K / 32, 4, 32, 16) int8, contiguous."""
    k, n = w_kn.shape
    if k % STEP_K or n % PASS_N:
        raise ValueError(f"the packed layout takes K a multiple of {STEP_K} and N of {PASS_N}, "
                         f"got ({k}, {n})")
    # k = 32 s + 16 half + 4 t + byte; n = 64 p + 16 q + 8 tile + g
    w = w_kn.reshape(k // STEP_K, 2, 4, 4, n // PASS_N, 4, 2, 8)
    # -> [p][s][q][g][t][tile][half][byte]; lane = 4 g + t, bytes 8 tile + 4 half + byte
    return w.permute(4, 0, 5, 7, 2, 6, 1, 3).reshape(n // PASS_N, k // STEP_K, 4, 32, 16).contiguous()
