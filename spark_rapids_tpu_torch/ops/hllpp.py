"""HyperLogLogPlusPlus (approx_count_distinct) sketches -- Spark-compatible
(reference hyper_log_log_plus_plus.cu/.hpp, HyperLogLogPlusPlusHostUDF):

  * hash = xxhash64(column, seed 42) (hyper_log_log_plus_plus.cu:59)
  * register index = hash >>> (64 - p); register value =
    countl_zero((hash << p) | w_padding) + 1 (:190-212)
  * sketch = 2^p 6-bit registers packed 10 per int64, stored as a STRUCT
    of (2^p/10 + 1) INT64 columns (:373-382)
  * estimate: harmonic mean + empirical bias correction in the mid
    zone + HLL++ linear-counting decision with the paper's
    per-precision thresholds (estimate_fn :852-875 delegates to the
    cuco finalizer).  The bias table (ops/hllpp_bias.npz) is the JAX
    package's, measured with its register pipeline (which this one
    reproduces bit for bit): the reference's table lives inside its
    cuco dependency, so the paper's measurement is reproduced rather
    than vendored; values can differ from Spark's table within
    estimator noise.

Register maxima are a scatter_reduce "amax" over (group, register) ids
into zeros; countl_zero is utils/u64math.clz64; packing is shift-and-sum
-- all on the column's device.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import hash as H
from spark_rapids_tpu_torch.utils.u64math import clz64, shr

_I32 = torch.int32
_I64 = torch.int64

REGISTER_VALUE_BITS = 6
REGISTERS_PER_LONG = 10
MASK = (1 << REGISTER_VALUE_BITS) - 1
MAX_PRECISION = 18
SEED = 42
# HLL++ linear-counting threshold per precision (paper appendix; what
# the cuco finalizer uses), p=4..18
_THRESHOLDS = {4: 10, 5: 20, 6: 40, 7: 80, 8: 220, 9: 400, 10: 900,
               11: 1800, 12: 3100, 13: 6500, 14: 11500, 15: 20000,
               16: 50000, 17: 120000, 18: 350000}


def _check_precision(precision: int) -> int:
    if precision < 4:
        raise ValueError(
            "HyperLogLogPlusPlus requires precision bigger than 4.")
    return min(precision, MAX_PRECISION)


def _registers_for(col: Column, precision: int):
    """(per-row register index, per-row register value, valid mask)."""
    hashes = H.xxhash64([col], SEED).data
    idx = shr(hashes, 64 - precision).to(_I32)
    w = (hashes << precision) | (1 << (precision - 1))
    return idx, clz64(w) + 1, col.valid_mask()


def _num_long_cols(precision: int) -> int:
    return (1 << precision) // REGISTERS_PER_LONG + 1


def _segment_max(vals: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Per-segment max of non-negative int32 values; an empty segment
    gives 0."""
    out = torch.zeros(num, dtype=_I32, device=vals.device)
    return out.scatter_reduce_(0, seg, vals.to(_I32), "amax")


def _pack_registers(regs: torch.Tensor, precision: int
                    ) -> List[torch.Tensor]:
    """(ngroups, 2^p) int32 register values -> list of (ngroups,) int64
    packed columns (10x6 bits per long)."""
    ngroups, m = regs.shape
    ncols = _num_long_cols(precision)
    pad = ncols * REGISTERS_PER_LONG - m
    if pad:
        regs = torch.nn.functional.pad(regs, (0, pad))
    r3 = regs.reshape(ngroups, ncols, REGISTERS_PER_LONG).to(_I64)
    shifts = REGISTER_VALUE_BITS * torch.arange(
        REGISTERS_PER_LONG, dtype=_I64, device=regs.device)
    packed = (r3 << shifts).sum(dim=2)
    # one row per long column, each with a unit stride (fresh strides:
    # a transposed view of one group would keep a stride of ncols)
    cols = torch.empty((ncols, ngroups), dtype=_I64, device=regs.device)
    cols.copy_(packed.t())
    return list(cols)


def _unpack_registers(longs: Sequence[torch.Tensor],
                      precision: int) -> torch.Tensor:
    """Inverse of _pack_registers: -> (ngroups, 2^p) int32."""
    m = 1 << precision
    stacked = torch.stack(list(longs), dim=1)           # (ngroups, ncols)
    shifts = REGISTER_VALUE_BITS * torch.arange(
        REGISTERS_PER_LONG, dtype=_I64, device=stacked.device)
    regs = (stacked[:, :, None] >> shifts) & MASK
    return regs.reshape(stacked.shape[0], -1)[:, :m].to(_I32)


def _sketch_struct(longs: List[torch.Tensor]) -> Column:
    n = int(longs[0].shape[0])
    children = [Column(dtypes.INT64, n, data=lg) for lg in longs]
    return Column.make_struct(n, children)


def group_hllpp(col: Column, group_ids: torch.Tensor, num_groups: int,
                precision: int) -> Column:
    """Per-group sketches as a STRUCT<INT64...> column
    (group_hyper_log_log_plus_plus)."""
    precision = _check_precision(precision)
    m = 1 << precision
    idx, val, valid = _registers_for(col, precision)
    flat = group_ids.to(_I64) * m + idx.to(_I64)
    flat = torch.where(valid, flat, num_groups * m)        # dropped
    maxes = _segment_max(torch.where(valid, val, 0), flat,
                         num_groups * m + 1)
    regs = maxes[: num_groups * m].reshape(num_groups, m)
    return _sketch_struct(_pack_registers(regs, precision))


def reduce_hllpp(col: Column, precision: int) -> Column:
    """Whole-column sketch (1-row struct; reduce_hyper_log_log_plus_plus)."""
    return group_hllpp(col, torch.zeros(col.length, dtype=_I32,
                                        device=col.device), 1, precision)


def merge_sketches(sketch_col: Column, group_ids: torch.Tensor,
                   num_groups: int, precision: int) -> Column:
    """Merge sketch rows by group (group_merge_hyper_log_log_plus_plus):
    per-register max."""
    precision = _check_precision(precision)
    if len(sketch_col.children) != _num_long_cols(precision):
        raise ValueError("The num of long columns in input is incorrect.")
    regs = _unpack_registers([c.data for c in sketch_col.children],
                             precision)
    m = 1 << precision
    flat = (group_ids.to(_I64)[:, None] * m
            + torch.arange(m, dtype=_I64, device=regs.device)[None, :])
    merged = _segment_max(regs.reshape(-1), flat.reshape(-1),
                          num_groups * m)
    return _sketch_struct(_pack_registers(merged.reshape(num_groups, m),
                                          precision))


def reduce_merge_hllpp(sketch_col: Column, precision: int) -> Column:
    return merge_sketches(sketch_col,
                          torch.zeros(sketch_col.length, dtype=_I32,
                                      device=sketch_col.device),
                          1, precision)


@functools.lru_cache(maxsize=None)
def _bias_host(precision: int):
    data = np.load(os.path.join(os.path.dirname(__file__),
                                "hllpp_bias.npz"))
    return data[f"raw_p{precision}"], data[f"bias_p{precision}"]


def _bias_table(precision: int, device):
    """(raw_estimate knots, bias knots) float64 tensors on `device`."""
    raw, bias = _bias_host(precision)
    return (torch.from_numpy(raw.astype(np.float64)).to(device),
            torch.from_numpy(bias.astype(np.float64)).to(device))


def estimate_from_hll_sketches(sketch_col: Column,
                               precision: int) -> Column:
    """INT64 estimates per sketch row (estimate_fn; HLL++ with linear
    counting for the small range)."""
    precision = _check_precision(precision)
    regs = _unpack_registers([c.data for c in sketch_col.children],
                             precision)
    m = 1 << precision
    if m == 16:
        alpha = 0.673
    elif m == 32:
        alpha = 0.697
    elif m == 64:
        alpha = 0.709
    else:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    s = torch.exp2(-regs.to(torch.float64)).sum(dim=1)
    zeroes = (regs == 0).sum(dim=1).to(torch.float64)
    # true divisions (a Python scalar over a tensor is a multiply by the
    # tensor's reciprocal in torch)
    raw = s.new_tensor(alpha * m * m) / s
    # empirical bias correction in the mid zone (raw <= 5m), paper
    # order: correct raw first, then the linear-counting decision.
    # ALGORITHM parity with Spark's HyperLogLogPlusPlusHelper: the bias
    # at a raw estimate is the MEAN OF THE K=6 NEAREST knots' biases
    # (Spark's kNN average over rawEstimateData/biasData), not a linear
    # interpolation; the small and large ranges are table-free and
    # exact
    raw_knots, bias_knots = _bias_table(precision, regs.device)
    k = 6
    nk = raw_knots.shape[0]
    idx = torch.searchsorted(raw_knots, raw)
    # nearest-k knots BY DISTANCE: with sorted knots they form a
    # contiguous window; among the k+1 candidate windows ending near
    # idx, pick the one whose FARTHEST member is closest (Spark's
    # estimateBias slides the window by exactly this criterion)
    best_lo = best_far = None
    for shift in range(k + 1):
        lo = (idx - k + shift).clamp(0, max(nk - k, 0))
        far = torch.maximum((raw - raw_knots[lo]).abs(),
                            (raw_knots[lo + k - 1] - raw).abs())
        if best_lo is None:
            best_lo, best_far = lo, far
        else:
            take = far < best_far
            best_lo = torch.where(take, lo, best_lo)
            best_far = torch.where(take, far, best_far)
    window = best_lo[:, None] + torch.arange(k, device=regs.device)[None, :]
    bias = bias_knots[window.clamp(0, nk - 1)].mean(dim=1)
    e = torch.where(raw <= 5.0 * m, raw - bias, raw)
    linear = m * torch.log(zeroes.new_tensor(float(m)) / zeroes.clamp(min=1))
    est = torch.where((zeroes > 0) & (linear <= _THRESHOLDS[precision]),
                      linear, e)
    return Column(dtypes.INT64, sketch_col.length,
                  data=torch.round(est).to(_I64))
