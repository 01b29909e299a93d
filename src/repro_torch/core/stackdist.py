"""LRU stack-distance machinery (Mattson et al. 1970).

The JAX reference package's module, with a device version of the batch
pass. Five implementations:

* :func:`_mattson_pass` — vectorized NumPy Mattson: for every touch it
  returns the number of *unique other bytes* touched since the previous
  touch of the same tensor. The per-touch distance decomposes into a prefix
  sum minus a weighted dominance correction, computed with argsort/
  searchsorted merge counting in O(T log^2 T) with no Python-level
  per-touch loop. This feeds the fractional-residency cache model in
  ``cachesim.py`` and the batched sweep engine in ``sweep.py``.

* :func:`_mattson_pass_batch` — the suite-level batch variant: one call
  covers a whole ``(n_traces, max_len)`` padded batch of touch streams
  (``cachesim.StreamBatch``). Every scan (prefix sums, merge counting)
  runs along ``axis=1`` so each row is computed with exactly the sequence
  of float operations :func:`_mattson_pass` performs on that stream alone
  — rows are bit-identical to per-trace calls, which is what lets the
  sweep engine batch a full scenario registry without perturbing results.

* :func:`_mattson_pass_batch_torch` — the same batch pass as torch tensor
  operations on int64/float64 tensors of any device: a stable
  ``torch.sort`` for the previous-touch chains, per-row ``searchsorted``
  for the merge levels, ``cumsum`` for the prefix sums, and no Python loop
  over touches. ``cachesim.build_streams`` runs it on the card. Touch sizes
  are whole numbers of bytes, so every prefix sum and every distance is a
  whole number below 2**53 and equals the NumPy pass to the bit, whatever
  order a device's scan sums in.

* :func:`_reference_mattson_pass` — the original per-touch Fenwick-tree
  pass, O(T log T) but Python-loop bound. Retained as the parity oracle for
  the vectorized kernels (``tests/test_sweep.py``) and for the before/after
  timing in ``benchmarks/bench_core.py``.

* :class:`BlockLRU` — an exact block-granular LRU simulator (slow, small
  traces only). Used by the property tests to validate the fractional model.
"""
from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


class Fenwick:
    """Fenwick tree over float weights."""

    def __init__(self, n: int):
        self.n = n
        self.tree = np.zeros(n + 1, dtype=np.float64)

    def add(self, i: int, delta: float) -> None:
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & (-i)

    def prefix(self, i: int) -> float:
        """Sum over [0, i] inclusive."""
        i += 1
        s = 0.0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return s

    def range(self, lo: int, hi: int) -> float:
        """Sum over [lo, hi] inclusive; 0 when empty."""
        if lo > hi:
            return 0.0
        return self.prefix(hi) - (self.prefix(lo - 1) if lo > 0 else 0.0)


def _reference_mattson_pass(tensor_ids: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """dist[t] = unique other bytes touched strictly between the previous
    touch of tensor_ids[t] and t; +inf for first touches.

    Per-touch Fenwick-tree oracle; see :func:`_mattson_pass` for the
    vectorized production path."""
    n = len(tensor_ids)
    fen = Fenwick(n)
    pos: dict[int, int] = {}
    dist = np.full(n, INF)
    for t in range(n):
        x = int(tensor_ids[t])
        s = float(sizes[t])
        p = pos.get(x)
        if p is not None:
            dist[t] = fen.range(p + 1, t - 1)
            fen.add(p, -s)
        fen.add(t, s)
        pos[x] = t
    return dist


def _prev_occurrence(tensor_ids: np.ndarray) -> np.ndarray:
    """prev[t] = index of the previous touch of tensor_ids[t]; -1 for firsts."""
    n = len(tensor_ids)
    order = np.argsort(tensor_ids, kind="stable")  # grouped, time-ordered
    sorted_ids = tensor_ids[order]
    prev_sorted = np.full(n, -1, dtype=np.int64)
    if n > 1:
        same = sorted_ids[1:] == sorted_ids[:-1]
        prev_sorted[1:][same] = order[:-1][same]
    prev = np.empty(n, dtype=np.int64)
    prev[order] = prev_sorted
    return prev


def _weighted_larger_before(values: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """out[t] = sum of weights[r] over r < t with values[r] > values[t].

    Weighted inversion counting via bottom-up merge: at each level, right
    half-blocks query the sorted left half-blocks with one global
    ``searchsorted`` (per-block composite keys keep the concatenation of
    sorted blocks globally sorted). O(n log^2 n), all NumPy.
    """
    n = len(values)
    out = np.zeros(n, dtype=np.float64)
    if n < 2:
        return out
    values = np.asarray(values, dtype=np.int64)
    base = int(values.max()) - int(values.min()) + 2
    vals = (values - int(values.min())).astype(np.int64)  # >= 0, < base - 1
    idx = np.arange(n, dtype=np.int64)
    m = 1
    while m < n:
        pair = idx // (2 * m)
        in_left = (idx // m) % 2 == 0
        left = idx[in_left]
        right = idx[~in_left]
        if len(right):
            # Sort left elements by (pair, value); composite keys make the
            # flat array globally sorted so one searchsorted serves all pairs.
            key_left = pair[left] * base + vals[left]
            ord_l = np.argsort(key_left, kind="stable")
            key_sorted = key_left[ord_l]
            w_sorted = weights[left][ord_l]
            cumw = np.concatenate([[0.0], np.cumsum(w_sorted)])
            q_pair = pair[right]
            # elements of my pair's left block with value <= mine:
            lo = np.searchsorted(key_sorted, q_pair * base + vals[right], side="right")
            # end of my pair's left block:
            hi = np.searchsorted(key_sorted, (q_pair + 1) * base, side="left")
            out[right] += cumw[hi] - cumw[lo]
        m *= 2
    return out


def _mattson_pass(tensor_ids: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Vectorized Mattson pass, same contract as the reference.

    Decomposition: with p = prev-touch of the tensor touched at t,

        dist[t] = sum(sizes[p+1 : t])                          (all touches)
                - sum(sizes[r] for p < r < t with prev[r] > p)  (re-touches)

    i.e. every tensor in the window is counted once, at its *first* touch
    inside the window — exactly what the Fenwick reference computes (its
    tree holds each tensor's weight at its most recent touch position).
    The correction term is a weighted dominance count: prev[r] > prev[t]
    with r < t implies r > p automatically, so it reduces to weighted
    inversion counting over the prev[] sequence.
    """
    tensor_ids = np.asarray(tensor_ids, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.float64)
    n = len(tensor_ids)
    dist = np.full(n, INF)
    if n == 0:
        return dist
    prev = _prev_occurrence(tensor_ids)
    has_prev = prev >= 0
    prefix = np.concatenate([[0.0], np.cumsum(sizes)])  # prefix[k] = sum sizes[:k]
    window = prefix[np.arange(n)] - prefix[np.clip(prev, 0, None) + 1]
    corr = _weighted_larger_before(prev, sizes)
    dist[has_prev] = window[has_prev] - corr[has_prev]
    return dist


#: Tensor-id padding sentinel for batched streams: larger than any dense id,
#: so pad slots group at the tail of every per-row stable sort.
PAD_ID = np.int64(1) << 62


def _prev_occurrence_batch(tensor_ids: np.ndarray) -> np.ndarray:
    """Row-wise :func:`_prev_occurrence`: ``prev[r, t]`` is the column of the
    previous touch of ``tensor_ids[r, t]`` within row ``r`` (-1 for firsts).
    Pad slots (``PAD_ID``) chain among themselves; callers mask them out."""
    n_rows, n = tensor_ids.shape
    order = np.argsort(tensor_ids, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(tensor_ids, order, axis=1)
    prev_sorted = np.full((n_rows, n), -1, dtype=np.int64)
    if n > 1:
        same = sorted_ids[:, 1:] == sorted_ids[:, :-1]
        prev_sorted[:, 1:][same] = order[:, :-1][same]
    prev = np.empty((n_rows, n), dtype=np.int64)
    np.put_along_axis(prev, order, prev_sorted, axis=1)
    return prev


def _weighted_larger_before_batch(
    values: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """Row-wise :func:`_weighted_larger_before`: ``out[r, t]`` sums
    ``weights[r, q]`` over ``q < t`` with ``values[r, q] > values[r, t]``.

    The merge tree is positional, so every row shares the same level/block
    structure; per-row ``argsort``/``cumsum`` along ``axis=1`` plus one
    row-offset ``searchsorted`` per level batch all rows through each merge
    level at once. Rows whose stream is shorter than the padded width see
    only weight-0 pad entries in their blocks, which add exact zeros to the
    prefix sums — each row's result is bit-identical to the 1D kernel on
    that row alone (asserted in tests).
    """
    n_rows, n = values.shape
    out = np.zeros((n_rows, n), dtype=np.float64)
    if n < 2 or n_rows == 0:
        return out
    values = np.asarray(values, dtype=np.int64)
    vmin = int(values.min())
    base = int(values.max()) - vmin + 2
    vals = (values - vmin).astype(np.int64)
    cols = np.arange(n, dtype=np.int64)
    rows = np.arange(n_rows, dtype=np.int64)[:, None]
    m = 1
    while m < n:
        pair = cols // (2 * m)
        in_left = (cols // m) % 2 == 0
        left = cols[in_left]
        right = cols[~in_left]
        if len(right):
            key_left = pair[left][None, :] * base + vals[:, left]
            ord_l = np.argsort(key_left, axis=1, kind="stable")
            key_sorted = np.take_along_axis(key_left, ord_l, axis=1)
            w_sorted = np.take_along_axis(weights[:, left], ord_l, axis=1)
            cumw = np.concatenate(
                [np.zeros((n_rows, 1)), np.cumsum(w_sorted, axis=1)], axis=1
            )
            q_pair = pair[right]
            # Per-row searchsorted: offset every row's (sorted) keys into a
            # disjoint band so one flat call serves the whole batch.
            row_base = (int(pair[-1]) + 2) * base
            flat_keys = (rows * row_base + key_sorted).ravel()
            q_lo = (rows * row_base + q_pair[None, :] * base + vals[:, right])
            q_hi = (rows * row_base + (q_pair + 1)[None, :] * base)
            lo = np.searchsorted(flat_keys, q_lo.ravel(), side="right") \
                .reshape(n_rows, -1) - rows * len(left)
            hi = np.searchsorted(flat_keys, q_hi.ravel(), side="left") \
                .reshape(n_rows, -1) - rows * len(left)
            out[:, right] += np.take_along_axis(cumw, hi, axis=1) \
                - np.take_along_axis(cumw, lo, axis=1)
        m *= 2
    return out


def _mattson_pass_batch(tensor_ids: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Batched Mattson over a padded ``(n_traces, max_len)`` touch batch.

    Pad slots carry ``PAD_ID`` ids and zero sizes; their distances are
    meaningless (callers slice rows to their true lengths). Every real row
    prefix is computed with the same per-row operation sequence as
    :func:`_mattson_pass`, so results are bit-identical to calling the 1D
    kernel once per trace — zero-weight pads only ever append exact zeros
    to the row-local prefix sums.
    """
    tensor_ids = np.asarray(tensor_ids, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.float64)
    n_rows, n = tensor_ids.shape
    dist = np.full((n_rows, n), INF)
    if n == 0 or n_rows == 0:
        return dist
    prev = _prev_occurrence_batch(tensor_ids)
    has_prev = prev >= 0
    prefix = np.concatenate(
        [np.zeros((n_rows, 1)), np.cumsum(sizes, axis=1)], axis=1
    )
    window = prefix[:, :n] - np.take_along_axis(prefix, np.clip(prev, 0, None) + 1, axis=1)
    corr = _weighted_larger_before_batch(prev, sizes)
    dist[has_prev] = window[has_prev] - corr[has_prev]
    return dist


def _prev_occurrence_batch_torch(tensor_ids: torch.Tensor) -> torch.Tensor:
    """:func:`_prev_occurrence_batch` on a torch tensor. The sort must be
    stable: it keeps each tensor's touches in time order, and an unstable
    sort chains a touch to the wrong earlier one."""
    sorted_ids, order = torch.sort(tensor_ids, dim=1, stable=True)
    prev_sorted = torch.full_like(tensor_ids, -1)
    if tensor_ids.shape[1] > 1:
        same = sorted_ids[:, 1:] == sorted_ids[:, :-1]
        prev_sorted[:, 1:] = torch.where(same, order[:, :-1], prev_sorted[:, 1:])
    return torch.empty_like(tensor_ids).scatter_(1, order, prev_sorted)


def _weighted_larger_before_batch_torch(values: torch.Tensor,
                                        weights: torch.Tensor) -> torch.Tensor:
    """:func:`_weighted_larger_before_batch` on torch tensors. The merge tree
    is the same; each level sorts the left half-blocks' ``pair * base +
    value`` keys (int64) row by row and searches them with a 2-D
    ``torch.searchsorted``, which keeps rows apart by itself (the NumPy pass
    offsets rows into bands for one flat search)."""
    n_rows, n = values.shape
    out = torch.zeros((n_rows, n), dtype=torch.float64, device=values.device)
    if n < 2 or n_rows == 0:
        return out
    vmin = values.min()
    base = values.max() - vmin + 2
    vals = values - vmin
    zero = torch.zeros((n_rows, 1), dtype=torch.float64, device=values.device)
    m = 1
    while m < n:
        # the left and right half-blocks' columns, ascending, as NumPy's
        # boolean masks give them (built by arithmetic: a mask would cost a
        # device sync a level)
        full, rest = divmod(n, 2 * m)
        n_left, n_right = full * m + min(rest, m), full * m + max(rest - m, 0)
        k = torch.arange(max(n_left, n_right), device=values.device)
        left = ((k // m) * (2 * m) + k % m)[:n_left]
        right = ((k // m) * (2 * m) + m + k % m)[:n_right]
        if n_right:
            key_left = (left // (2 * m))[None, :] * base + vals[:, left]
            key_sorted, ord_l = torch.sort(key_left, dim=1, stable=True)
            w_sorted = torch.gather(weights[:, left], 1, ord_l)
            cumw = torch.cat([zero, torch.cumsum(w_sorted, dim=1)], dim=1)
            q_pair = (right // (2 * m))[None, :]
            lo = torch.searchsorted(key_sorted, q_pair * base + vals[:, right], right=True)
            hi = torch.searchsorted(key_sorted, ((q_pair + 1) * base).expand(n_rows, -1).contiguous())
            out[:, right] += torch.gather(cumw, 1, hi) - torch.gather(cumw, 1, lo)
        m *= 2
    return out


def _mattson_pass_batch_torch(tensor_ids: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """:func:`_mattson_pass_batch` as torch operations on the tensors'
    device: ``tensor_ids`` int64 and ``sizes`` float64, both ``(n_traces,
    max_len)``, pads ``PAD_ID`` with size 0. Returns the float64 distances
    on the same device, +inf for first touches."""
    if tensor_ids.dtype != torch.int64 or sizes.dtype != torch.float64:
        raise TypeError("the batch pass takes int64 ids and float64 sizes")
    n_rows, n = tensor_ids.shape
    dist = torch.full((n_rows, n), INF, dtype=torch.float64, device=tensor_ids.device)
    if n == 0 or n_rows == 0:
        return dist
    prev = _prev_occurrence_batch_torch(tensor_ids)
    prefix = torch.cat([torch.zeros((n_rows, 1), dtype=torch.float64, device=sizes.device),
                        torch.cumsum(sizes, dim=1)], dim=1)
    window = prefix[:, :n] - torch.gather(prefix, 1, prev.clamp(min=0) + 1)
    corr = _weighted_larger_before_batch_torch(prev, sizes)
    return torch.where(prev >= 0, window - corr, dist)


def reuse_distances(
    tensor_ids: np.ndarray,
    sizes: np.ndarray,
    cyclic: bool = True,
) -> np.ndarray:
    """Bytes-weighted unique-reuse distance per touch.

    ``tensor_ids[t]`` identifies the tensor touched at step t; ``sizes[t]``
    its size in bytes. First touches are cold (+inf) unless ``cyclic``: then
    the trace is treated as a steady-state loop (the paper simulates one
    end-to-end iteration of a workload that runs for thousands of
    iterations), implemented by doubling the trace and reading distances off
    the second copy.
    """
    tensor_ids = np.asarray(tensor_ids, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.float64)
    n = len(tensor_ids)
    if n == 0:
        return np.zeros(0)
    if not cyclic:
        return _mattson_pass(tensor_ids, sizes)
    ids2 = np.concatenate([tensor_ids, tensor_ids])
    sz2 = np.concatenate([sizes, sizes])
    return _mattson_pass(ids2, sz2)[n:]


class BlockLRU:
    """Exact fully-associative LRU over fixed-size blocks (validation only).

    Write-back, write-allocate-without-fill for full-block writes (DL stores
    stream whole tensors, so a written block needs no fill). ``fill_bytes``
    counts fetches from the next level, ``writeback_bytes`` dirty evictions.
    """

    def __init__(self, capacity_bytes: int, block_bytes: int = 1 << 20):
        from collections import OrderedDict

        self.block = block_bytes
        self.ways = max(int(capacity_bytes // block_bytes), 1)
        self.lru: "OrderedDict[tuple[int, int], bool]" = OrderedDict()
        self.fill_bytes = 0
        self.writeback_bytes = 0

    def touch_tensor(self, tensor_id: int, nbytes: int, is_write: bool) -> None:
        nblocks = max(1, -(-int(nbytes) // self.block))
        for b in range(nblocks):
            self._access((tensor_id, b), is_write)

    def _access(self, key: tuple[int, int], is_write: bool) -> None:
        if key in self.lru:
            dirty = self.lru.pop(key)
            self.lru[key] = dirty or is_write
            return
        if not is_write:
            self.fill_bytes += self.block
        self.lru[key] = is_write
        if len(self.lru) > self.ways:
            _, dirty = self.lru.popitem(last=False)
            if dirty:
                self.writeback_bytes += self.block
