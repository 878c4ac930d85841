"""Sample statistics over repeated measurement runs.

Equivalent of the reference's src/util/sample.hpp:11-135: given the raw
per-run observations, report size / min / max / mean / median / variance /
standard deviation / skewness / kurtosis, and render them as a JSON block
with a unit (reference print_sample, src/util/sample.hpp:138-165).

Note the reference's median has a dead branch (``n % 1 == 0`` is always
true, src/util/sample.hpp:51-53) so it always returns the UPPER middle
order statistic ``v_sorted[n/2]`` — for even n it never averages.  We
implement the *correct* median (even n: mean of the two middle order
statistics; odd n: the middle one), which coincides with the
reference's output for odd n and deviates by half the middle gap for
even n (documented deviation, pinned by the differential test
tests/test_reference_diff.py::test_profiling_estimator_semantics).

The port's copy of ``spmv_tpu/utils/sample.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = ["Sample", "compute_sample"]


@dataclasses.dataclass(frozen=True)
class Sample:
    """Summary statistics of a sample of observations."""

    size: int
    values: tuple
    unit: str = ""

    @property
    def min(self) -> float:
        return min(self.values)

    @property
    def max(self) -> float:
        return max(self.values)

    @property
    def mean(self) -> float:
        return math.fsum(self.values) / self.size

    @property
    def median(self) -> float:
        s = sorted(self.values)
        n = self.size
        if n % 2 == 0:
            return 0.5 * (s[n // 2 - 1] + s[n // 2])
        return s[n // 2]

    def _central_moment(self, k: int) -> float:
        mu = self.mean
        return math.fsum((v - mu) ** k for v in self.values) / self.size

    @property
    def variance(self) -> float:
        # Unbiased sample variance (n-1 denominator), matching the
        # reference (src/util/sample.hpp:95-106) including its n=1
        # degenerate value: 0.0/0 in C++ is NaN, and that NaN is what
        # the reference's print_sample reports for a single run.
        if self.size < 2:
            return float("nan")
        mu = self.mean
        return math.fsum((v - mu) ** 2 for v in self.values) / (self.size - 1)

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance) if self.variance == self.variance \
            else float("nan")

    @property
    def skewness(self) -> float:
        # The reference's estimator is the HYBRID m3 / variance^1.5 —
        # n-denominator third moment over the (n-1)-denominator
        # variance (src/util/sample.hpp:118-126), NOT the adjusted
        # Fisher-Pearson coefficient.  Pinned bit-for-bit by the
        # sample.hpp harness differential
        # (tests/test_reference_diff.py).  Degenerate cases follow the
        # C++ arithmetic: 0/0 and x/NaN are NaN.
        m3 = self._central_moment(3)
        var = self.variance
        if var != var or var == 0.0:     # NaN or zero denominator
            return float("nan")
        return m3 / math.sqrt(var * var * var)

    @property
    def kurtosis(self) -> float:
        # Plain (non-excess) sample kurtosis m4/m2^2, as in the
        # reference (src/util/sample.hpp:127-135); m2 == 0 gives the
        # C++ 0/0 NaN.
        m2 = self._central_moment(2)
        m4 = self._central_moment(4)
        if m2 == 0.0:
            return float("nan")
        return m4 / (m2 * m2)

    def to_json(self, include_values: bool = False) -> dict:
        """JSON block in the shape of print_sample (sample.hpp:138-165)."""
        d = {
            # key name matches the reference's print_sample
            # (sample.hpp:143-145)
            "samples": self.size,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "median": self.median,
            "variance": self.variance,
            "standard_deviation": self.stddev,
            "skewness": self.skewness,
            "kurtosis": self.kurtosis,
            "unit": self.unit,
        }
        if include_values:
            d["values"] = list(self.values)
        return d


def compute_sample(values: Sequence[float], unit: str = "") -> Sample:
    values = tuple(float(v) for v in values)
    if not values:
        raise ValueError("empty sample")
    return Sample(size=len(values), values=values, unit=unit)
