"""JSON report output.

Equivalent of the reference's src/util/json-ostreambuf.{cpp,hpp}: pretty
printed (2-space indented) JSON where non-finite floats are rendered as
quoted strings (the reference imbues a locale that prints NaN as "nan",
src/util/json-ostreambuf.cpp:16-43).  Python's json module would emit
bare ``NaN`` / ``Infinity`` tokens (invalid JSON), so we sanitize.

The port's copy of ``spmv_tpu/utils/jsonio.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import json
import math
from typing import Any, IO

import numpy as np

__all__ = ["json_dumps", "dump_json", "sanitize"]


def sanitize(obj: Any) -> Any:
    """Recursively convert to plain JSON-safe Python types.

    - numpy scalars/arrays -> Python scalars / lists
    - NaN -> "nan", +/-inf -> "inf"/"-inf" (quoted, valid JSON)
    """
    if isinstance(obj, dict):
        return {str(k): sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [sanitize(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        obj = float(obj)
    if isinstance(obj, float):
        if math.isnan(obj):
            return "nan"
        if math.isinf(obj):
            return "inf" if obj > 0 else "-inf"
        return obj
    return obj


def json_dumps(obj: Any, indent: int = 2) -> str:
    return json.dumps(sanitize(obj), indent=indent)


def dump_json(obj: Any, stream: IO[str], indent: int = 2) -> None:
    stream.write(json_dumps(obj, indent=indent))
    stream.write("\n")
