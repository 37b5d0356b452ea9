"""Minimal affine-map algebra for itensor iteration maps.

StreamTensor's iteration maps (paper §3.1.2) are projection/permutation maps:
every data dimension is fed by exactly one iteration dimension, and iteration
dimensions may be dropped (re-iteration / reuse dims, Fig. 5(c)).  We therefore
represent a map ``(d0, .., d{n-1}) -> (d_{r0}, .., d_{r_{m-1}})`` as the tuple
``results = (r0, .., r_{m-1})`` of iteration-dim positions, one per data dim.

This covers everything in the paper; general affine expressions are not needed
and would weaken the analytical converter-size inference of Algorithm 1.

A copy of the reference's ``repro.core.affine``, with the same names
and results.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple


@dataclass(frozen=True)
class AffineMap:
    """Projection/permutation map from an iteration space to a data space.

    Attributes:
        num_dims: rank of the iteration space (number of loops).
        results:  for each data dimension ``j``, ``results[j]`` is the
                  iteration-dim position that indexes it.
    """

    num_dims: int
    results: Tuple[int, ...]

    def __post_init__(self) -> None:
        if any(not (0 <= r < self.num_dims) for r in self.results):
            raise ValueError(
                f"map results {self.results} out of range for {self.num_dims} dims"
            )
        if len(set(self.results)) != len(self.results):
            raise ValueError(f"map results must be injective, got {self.results}")

    # ------------------------------------------------------------------ #
    @property
    def num_results(self) -> int:
        return len(self.results)

    @property
    def reuse_dims(self) -> Tuple[int, ...]:
        """Iteration dims that feed no data dim (re-iteration dims)."""
        used = set(self.results)
        return tuple(d for d in range(self.num_dims) if d not in used)

    def is_permutation(self) -> bool:
        return self.num_dims == self.num_results

    def is_identity(self) -> bool:
        return self.results == tuple(range(self.num_dims))

    # ------------------------------------------------------------------ #
    def apply(self, indices: Sequence[int]) -> Tuple[int, ...]:
        """Map one iteration-index vector to a data-index vector."""
        if len(indices) != self.num_dims:
            raise ValueError(f"expected {self.num_dims} indices, got {len(indices)}")
        return tuple(indices[r] for r in self.results)

    def compose_permutation(self, perm: Sequence[int]) -> "AffineMap":
        """Return the map obtained by permuting the *iteration* dims.

        ``perm[k]`` is the old position of the new k-th loop, so result
        positions must be rewritten through the inverse permutation.
        """
        inv = {old: new for new, old in enumerate(perm)}
        return AffineMap(self.num_dims, tuple(inv[r] for r in self.results))

    def drop_dims(self, dims: Sequence[int]) -> "AffineMap":
        """Remove iteration dims (must all be reuse dims) and renumber."""
        dims_set = set(dims)
        if dims_set & set(self.results):
            raise ValueError("cannot drop iteration dims that feed data dims")
        remaining = [d for d in range(self.num_dims) if d not in dims_set]
        renum = {old: new for new, old in enumerate(remaining)}
        return AffineMap(len(remaining), tuple(renum[r] for r in self.results))

    # ------------------------------------------------------------------ #
    @staticmethod
    def identity(rank: int) -> "AffineMap":
        return AffineMap(rank, tuple(range(rank)))

    @staticmethod
    def transpose2d() -> "AffineMap":
        return AffineMap(2, (1, 0))

    @staticmethod
    def permutation(perm: Sequence[int]) -> "AffineMap":
        return AffineMap(len(perm), tuple(perm))

    def __str__(self) -> str:
        ins = ", ".join(f"d{i}" for i in range(self.num_dims))
        outs = ", ".join(f"d{r}" for r in self.results)
        return f"({ins}) -> ({outs})"


def lexicographic_indices(tripcounts: Sequence[int]) -> Iterator[Tuple[int, ...]]:
    """Row-major (last dim fastest) enumeration of an iteration space."""
    yield from itertools.product(*(range(t) for t in tripcounts))
