"""Iterative tensor (itensor) type system — paper §3.1.

An itensor explicitly encodes the *stream layout* of a tensor flowing between
dataflow kernels:

  * ``elem_shape``  — the shape of the tensor slice (tile) communicated as one
    stream token;
  * ``tripcounts`` / ``steps`` — the iteration space: nested loops with these
    trip counts, where loop ``k`` advances by ``steps[k]`` data elements per
    iteration;
  * ``iter_map``    — an affine (projection/permutation) map from iteration
    indices to data-space offsets.  Iteration dims absent from the map are
    *reuse* dims: the covered data is re-streamed once per iteration
    (Fig. 5(c) of the paper).

Together these uniquely determine the order in which tiles of the underlying
tensor appear on the stream, which is exactly the information classic
``tensor<8x8xf32>`` types lack (paper §3.1.1).  Two kernels may be fused with a
raw FIFO iff their itensor types match; otherwise a stream-layout converter
with an analytically-inferred ping-pong buffer is required (converter.py).

A copy of the reference's ``repro.core.itensor`` with the same names and
results.  The reference's ``ITensorType.block_spec_args`` (the bridge to a
Pallas ``BlockSpec``) is left out: nothing but Pallas code calls it, and the
port's layout converter (``kernels/stream_converter.py``) decodes each
stream token from ``tripcounts``, ``steps`` and ``iter_map`` itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .affine import AffineMap, lexicographic_indices

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2, "float16": 2, "f16": 2,
    "int32": 4, "i32": 4, "int8": 1, "i8": 1, "uint8": 1, "u8": 1,
    # Sub-byte packings are exact fractions, matching the paged cache's
    # ``kv_itemsize_effective`` (= pool bytes / logical elements).
    "int4": 0.5, "i4": 0.5, "uint4": 0.5, "u4": 0.5,
    # Both fp8 encodings the quantized KV pools may carry (DESIGN.md §14).
    "float8_e4m3fn": 1, "float8_e4m3": 1, "f8_e4m3": 1, "f8": 1,
    "float8_e5m2": 1, "f8_e5m2": 1, "e5m2": 1,
}


def dtype_bytes(dtype: str) -> float:
    """Bytes per element for an itensor dtype string.

    Exact (possibly fractional) for the table above; falls back to numpy
    for anything else.  ``np.dtype`` does not know jax's extended dtypes
    (bfloat16, fp8) — those must come from the table, so the fallback
    failure is rewritten into a diagnosable error naming the dtype.
    """
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        pass
    try:
        return np.dtype(dtype).itemsize
    except TypeError as e:
        raise ValueError(f"unknown itensor dtype {dtype!r}") from e


@dataclass(frozen=True)
class ITensorType:
    """The iterative tensor type (paper Fig. 5).

    Invariants (checked):
      * ``len(tripcounts) == len(steps) == iter_map.num_dims``
      * ``iter_map.num_results == len(elem_shape)`` (one loop per data dim)
      * for each data dim ``j`` fed by loop ``k = iter_map.results[j]``:
        ``elem_shape[j] <= steps[k]`` (tiles do not overlap) and the covered
        extent is ``tripcounts[k] * steps[k]``.
    """

    elem_shape: Tuple[int, ...]
    tripcounts: Tuple[int, ...]
    steps: Tuple[int, ...]
    iter_map: AffineMap
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if len(self.tripcounts) != len(self.steps):
            raise ValueError("tripcounts and steps must have equal rank")
        if self.iter_map.num_dims != len(self.tripcounts):
            raise ValueError(
                f"iter_map has {self.iter_map.num_dims} dims, iteration space "
                f"has {len(self.tripcounts)}"
            )
        if self.iter_map.num_results != len(self.elem_shape):
            raise ValueError(
                f"iter_map has {self.iter_map.num_results} results, element "
                f"shape has rank {len(self.elem_shape)}"
            )
        if any(t <= 0 for t in self.tripcounts) or any(s <= 0 for s in self.steps):
            raise ValueError("tripcounts/steps must be positive")
        for j, k in enumerate(self.iter_map.results):
            if self.elem_shape[j] > self.steps[k]:
                raise ValueError(
                    f"data dim {j}: element extent {self.elem_shape[j]} exceeds "
                    f"step {self.steps[k]} of loop d{k} (tiles would overlap)"
                )

    # -------------------------------------------------------------- shapes
    @property
    def rank(self) -> int:
        """Data-space rank."""
        return len(self.elem_shape)

    @property
    def iter_rank(self) -> int:
        return len(self.tripcounts)

    @property
    def data_shape(self) -> Tuple[int, ...]:
        """Extent of the underlying tensor covered by the stream."""
        return tuple(
            self.tripcounts[k] * self.steps[k] for k in self.iter_map.results
        )

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Number of distinct tiles along each data dim."""
        return tuple(self.tripcounts[k] for k in self.iter_map.results)

    @property
    def reuse_dims(self) -> Tuple[int, ...]:
        return self.iter_map.reuse_dims

    @property
    def reuse_factor(self) -> int:
        """How many times each tile is (re-)streamed."""
        f = 1
        for d in self.reuse_dims:
            f *= self.tripcounts[d]
        return f

    # -------------------------------------------------------------- tokens
    @property
    def num_tokens(self) -> int:
        """Total stream length in tiles for one pass (paper's ``T``)."""
        return math.prod(self.tripcounts)

    @property
    def token_bytes(self) -> float:
        return math.prod(self.elem_shape) * dtype_bytes(self.dtype)

    @property
    def total_bytes(self) -> float:
        return self.num_tokens * self.token_bytes

    @property
    def data_bytes(self) -> float:
        return math.prod(self.data_shape) * dtype_bytes(self.dtype)

    def is_exact_tiling(self) -> bool:
        """True if tiles abut exactly (step == element extent on every dim)."""
        return all(
            self.elem_shape[j] == self.steps[k]
            for j, k in enumerate(self.iter_map.results)
        )

    # -------------------------------------------------------- stream order
    def stream_offsets(self) -> Iterator[Tuple[int, ...]]:
        """Yield data-space offsets of tiles in stream order.

        The iteration space is walked row-major (last loop fastest), exactly
        the ``scf.for`` nest semantics of the paper's examples.
        """
        steps, results = self.steps, self.iter_map.results
        for idx in lexicographic_indices(self.tripcounts):
            yield tuple(idx[k] * steps[k] for k in results)

    def stream_tile_ids(self) -> Iterator[int]:
        """Yield linearized tile ids (row-major over ``grid_shape``)."""
        grid = self.grid_shape
        strides = [0] * len(grid)
        acc = 1
        for j in reversed(range(len(grid))):
            strides[j] = acc
            acc *= grid[j]
        results, steps = self.iter_map.results, self.steps
        for idx in lexicographic_indices(self.tripcounts):
            tid = 0
            for j, k in enumerate(results):
                tid += idx[k] * strides[j]
            yield tid

    # -------------------------------------------------------- equivalence
    def matches(self, other: "ITensorType") -> bool:
        """Structural type match (paper's fusion legality check, Fig. 5 Case1)."""
        return self == other

    def canonicalize(self) -> "ITensorType":
        """Drop trip-count-1 reuse dims; they do not affect stream order."""
        drop = [d for d in self.reuse_dims if self.tripcounts[d] == 1]
        if not drop:
            return self
        keep = [d for d in range(self.iter_rank) if d not in drop]
        return ITensorType(
            elem_shape=self.elem_shape,
            tripcounts=tuple(self.tripcounts[d] for d in keep),
            steps=tuple(self.steps[d] for d in keep),
            iter_map=self.iter_map.drop_dims(drop),
            dtype=self.dtype,
        )

    def equivalent(self, other: "ITensorType") -> bool:
        """Semantic equality: same tile sequence on the wire."""
        a, b = self.canonicalize(), other.canonicalize()
        if (a.elem_shape, a.dtype, a.data_shape) != (b.elem_shape, b.dtype, b.data_shape):
            return False
        if a.num_tokens != b.num_tokens:
            return False
        if a == b:
            return True
        # Fall back to bounded enumeration — used in verification only.
        for x, y in zip(a.stream_offsets(), b.stream_offsets()):
            if x != y:
                return False
        return True

    # ------------------------------------------------------ transformations
    def with_dtype(self, dtype: str) -> "ITensorType":
        return replace(self, dtype=dtype)

    def permute_loops(self, perm: Sequence[int]) -> "ITensorType":
        """Reorder the loop nest; ``perm[k]`` = old position of new loop k."""
        if sorted(perm) != list(range(self.iter_rank)):
            raise ValueError(f"bad permutation {perm}")
        return ITensorType(
            elem_shape=self.elem_shape,
            tripcounts=tuple(self.tripcounts[p] for p in perm),
            steps=tuple(self.steps[p] for p in perm),
            iter_map=self.iter_map.compose_permutation(perm),
            dtype=self.dtype,
        )

    def vectorize(self, factors: Sequence[int]) -> "ITensorType":
        """Widen the token by ``factors`` along each data dim (paper §4.3.3).

        The innermost loops shrink accordingly; tokens become
        ``elem_shape * factors`` blocks.  Requires divisibility.
        """
        if len(factors) != self.rank:
            raise ValueError("need one factor per data dim")
        new_elem, new_trip, new_step = (
            list(self.elem_shape), list(self.tripcounts), list(self.steps))
        for j, f in enumerate(factors):
            if f == 1:
                continue
            k = self.iter_map.results[j]
            if self.tripcounts[k] % f != 0:
                raise ValueError(
                    f"tripcount {self.tripcounts[k]} of loop d{k} not divisible "
                    f"by vector factor {f}")
            new_elem[j] = self.elem_shape[j] * f
            new_trip[k] = self.tripcounts[k] // f
            new_step[k] = self.steps[k] * f
        return ITensorType(tuple(new_elem), tuple(new_trip), tuple(new_step),
                           self.iter_map, self.dtype)

    # ------------------------------------------------------------- display
    def __str__(self) -> str:
        es = "x".join(map(str, self.elem_shape))
        space = "x".join(map(str, self.tripcounts)) + "*" + "x".join(map(str, self.steps))
        return f"itensor<{es}x{self.dtype}, [{space}], {self.iter_map}>"


# ---------------------------------------------------------------------- #
# Constructors
# ---------------------------------------------------------------------- #

def itensor_from_tiling(
    data_shape: Sequence[int],
    tile_shape: Sequence[int],
    loop_order: Optional[Sequence[int]] = None,
    reuse: Optional[Sequence[Tuple[int, int]]] = None,
    dtype: str = "float32",
) -> ITensorType:
    """Build an itensor for an exact tiling of ``data_shape``.

    Args:
        data_shape: underlying tensor shape; each dim must be divisible by the
            corresponding tile extent.
        tile_shape: element (token) shape.
        loop_order: order in which *data* dims are walked, outermost first.
            Default: row-major (``range(rank)``).  E.g. ``(1, 0)`` streams a
            matrix column-of-tiles-major — the Fig. 5(b) layout.
        reuse: list of ``(position, count)`` pairs inserting re-iteration loops
            at the given position of the final loop nest (Fig. 5(c)).
        dtype: element dtype.
    """
    rank = len(data_shape)
    if len(tile_shape) != rank:
        raise ValueError("tile rank must equal data rank")
    for d, t in zip(data_shape, tile_shape):
        if d % t != 0:
            raise ValueError(f"data extent {d} not divisible by tile extent {t}")
    order = list(loop_order) if loop_order is not None else list(range(rank))
    if sorted(order) != list(range(rank)):
        raise ValueError(f"loop_order must be a permutation, got {order}")

    # Loop k walks data dim order[k].
    tripcounts = [data_shape[order[k]] // tile_shape[order[k]] for k in range(rank)]
    steps = [tile_shape[order[k]] for k in range(rank)]
    # Data dim j is fed by the loop at position order.index(j).
    results = [order.index(j) for j in range(rank)]

    if reuse:
        # Insert reuse loops (outer positions first to keep indices stable).
        for pos, count in sorted(reuse, reverse=True):
            tripcounts.insert(pos, count)
            steps.insert(pos, 1)
            results = [r + 1 if r >= pos else r for r in results]

    return ITensorType(
        elem_shape=tuple(tile_shape),
        tripcounts=tuple(tripcounts),
        steps=tuple(steps),
        iter_map=AffineMap(len(tripcounts), tuple(results)),
        dtype=dtype,
    )


def row_major(data_shape: Sequence[int], tile_shape: Sequence[int],
              dtype: str = "float32") -> ITensorType:
    return itensor_from_tiling(data_shape, tile_shape, dtype=dtype)


def col_major(data_shape: Sequence[int], tile_shape: Sequence[int],
              dtype: str = "float32") -> ITensorType:
    rank = len(data_shape)
    order = list(range(rank))
    order[-1], order[-2] = order[-2], order[-1]
    return itensor_from_tiling(data_shape, tile_shape, loop_order=order, dtype=dtype)


# Paper Fig. 5 worked examples, used across the test-suite. ------------- #

def fig5_b() -> ITensorType:
    """tensor<8x8xf32> as 4x2 tiles, iteration [4,2]*[2,4], map (d0,d1)->(d1,d0)."""
    return ITensorType((4, 2), (4, 2), (2, 4), AffineMap(2, (1, 0)), "float32")


def fig5_c() -> ITensorType:
    """Fig. 5(c): iteration [4,2,2]*[2,1,4], map (d0,d1,d2)->(d2,d0)."""
    return ITensorType((4, 2), (4, 2, 2), (2, 1, 4), AffineMap(3, (2, 0)), "float32")
