"""Virtual memory layout and the page-ownership model.

The reference's reference strings carry *real* heap pointers into
page-aligned arrays, and NUMA attribution comes from a block
page-ownership model (src/util/aligned-allocator.hpp:156-211): element
index -> page -> the thread whose equal-block partition of the array
covers that page's start address.

The TPU build has no reason to allocate host arrays just to take their
addresses: a ``VirtualLayout`` hands out page-aligned *virtual* base
addresses, and the ownership model is reproduced as vectorized pure
functions of (base, num_elements, itemsize, num_threads, page_size).
Because all arrays are page-aligned (as the reference's allocator
guarantees, aligned-allocator.hpp:65-87), addresses never collide
between arrays and the simulated miss counts match a same-layout native
run.

The port's copy of ``spmv_tpu/perfmodel/layout.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = [
    "VirtualLayout",
    "VirtualArray",
    "page_of_index",
    "thread_of_page",
    "thread_of_index",
]

PAGE_SIZE_DEFAULT = 4096


@dataclasses.dataclass(frozen=True)
class VirtualArray:
    """A named page-aligned array in the virtual address space."""

    name: str
    base: int           # byte address, page-aligned
    num_elements: int
    itemsize: int

    @property
    def nbytes(self) -> int:
        return self.num_elements * self.itemsize

    def addresses(self, indices) -> np.ndarray:
        """Byte addresses of the given element indices (vectorized)."""
        return self.base + np.asarray(indices, dtype=np.uint64) * np.uint64(
            self.itemsize
        )


class VirtualLayout:
    """Sequential page-aligned allocator in a virtual address space."""

    def __init__(self, page_size: int = PAGE_SIZE_DEFAULT, base: int = 1 << 20):
        self.page_size = page_size
        self._next = base
        self.arrays: Dict[str, VirtualArray] = {}

    def allocate(self, name: str, num_elements: int, itemsize: int
                 ) -> VirtualArray:
        if name in self.arrays:
            raise ValueError(f"array {name!r} already allocated")
        base = -(-self._next // self.page_size) * self.page_size
        arr = VirtualArray(name, base, int(num_elements), int(itemsize))
        self.arrays[name] = arr
        # Leave one guard page between arrays so lines never straddle
        # two arrays (mirrors distinct heap allocations).
        self._next = base + max(arr.nbytes, 1) + self.page_size
        return arr

    def __getitem__(self, name: str) -> VirtualArray:
        return self.arrays[name]


def page_of_index(
    arr: VirtualArray, indices, page_size: int
) -> np.ndarray:
    """Page number (relative to the aligned base) of each element.

    Vectorized equivalent of aligned-allocator.hpp:179-199 for a
    page-aligned base: page = floor(index * itemsize / page_size).
    """
    idx = np.asarray(indices, dtype=np.int64)
    return (idx * arr.itemsize) // page_size


def thread_of_page(
    arr: VirtualArray, pages, num_threads: int, page_size: int
) -> np.ndarray:
    """Owner thread of each page under the equal-block partition.

    Vectorized equivalent of aligned-allocator.hpp:156-177: thread t
    owns pages whose start byte offset lies within
    [t*bpt*itemsize, (t+1)*bpt*itemsize) where bpt =
    ceil(num_elements/num_threads); pages beyond every block (or when
    all blocks are empty) fall to the last thread.
    """
    pages = np.asarray(pages, dtype=np.int64)
    n = arr.num_elements
    per = -(-n // num_threads) if n else 0
    starts = np.minimum(np.arange(num_threads + 1, dtype=np.int64) * per, n)
    start_bytes = starts * arr.itemsize
    page_addr = pages * page_size
    # First thread whose [start, end) contains page_addr.  Blocks are
    # contiguous, so searchsorted on the start offsets works; empty
    # trailing blocks share the same start as the end of data, and
    # side='right'-1 picks the last one, which the reference's fallback
    # (return num_threads-1) also effectively does for out-of-range
    # pages.
    owner = np.searchsorted(start_bytes[1:-1], page_addr, side="right")
    return np.clip(owner, 0, num_threads - 1).astype(np.int32)


def thread_of_index(
    arr: VirtualArray, indices, num_threads: int,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> np.ndarray:
    """Owner thread of each element index
    (aligned-allocator.hpp:201-211), vectorized."""
    return thread_of_page(
        arr, page_of_index(arr, indices, page_size), num_threads, page_size
    )
