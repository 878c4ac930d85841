"""Matrix Market parser and loader.

Reimplements the ingestion capabilities of the reference's
src/matrix/matrix-market.{cpp,hpp} with numpy-vectorized parsing:

- ``%%MatrixMarket object format field symmetry`` header validation
  (reference: matrix-market.cpp:416-436),
- comment lines (438-447), size line with overflow/validity checks
  (449-482),
- coordinate entries for real / integer / complex / pattern fields
  (530-556); pattern values read back as 1.0 (matrix-market.cpp:272),
- ``load_matrix`` path dispatch: ``.tar.gz``/``.tgz`` SuiteSparse
  tarballs (member ``stem/stem.mtx``, matrix-market.cpp:753-775),
  ``.gz``, and plain files (777-861), with ``__RCM`` / ``__GP<n>``
  reordering suffixes (782-801),
- row-/column-major sorting (863-929), symmetric permutation
  (``permute``, 309-333), row-length histogram helpers (282-307).

Beyond the reference we optionally *expand* symmetric / skew-symmetric /
hermitian storage to general form (the reference parses symmetry but
never expands it — a symmetric file yields only its stored triangle;
``expand_symmetry=False`` reproduces that).

Indices are stored 1-based exactly as in the file, as in the reference's
matrix_market::Matrix; format converters subtract 1.

The port's copy of ``spmv_tpu/io/matrix_market.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import re
import sys
import tarfile
from typing import Optional, Union

import numpy as np

from spmv_tpu_torch.errors import MatrixError

# files at least this large dispatch to the native C++ parser
# (amortizes the ctypes/library fixed cost; see load_matrix)
NATIVE_INGEST_THRESHOLD = 1 << 20

__all__ = ["MatrixMarket", "parse_matrix_market", "load_matrix"]

_OBJECTS = ("matrix", "vector")
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "double", "complex", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")

INDEX_DTYPE = np.int32
VALUE_DTYPE = np.float64


@dataclasses.dataclass
class MatrixMarket:
    """A parsed Matrix Market object.

    ``rows_1based`` / ``cols_1based`` keep the file's 1-based indexing
    (converters subtract one), ``values`` is float64 (complex stored as
    its real part only when asked via values_real, like the reference's
    ``values_real()`` which returns entry.real — matrix-market.cpp:249).
    """

    object: str
    format: str
    field: str
    symmetry: str
    num_rows: int
    num_columns: int
    num_entries: int
    rows_1based: np.ndarray
    cols_1based: np.ndarray
    values: np.ndarray          # float64 (real part for complex)
    values_imag: Optional[np.ndarray] = None
    comments: tuple = ()

    # -- accessors (reference matrix-market.cpp:171-277) ---------------

    def row_indices(self) -> np.ndarray:
        return self.rows_1based

    def column_indices(self) -> np.ndarray:
        return self.cols_1based

    def values_real(self) -> np.ndarray:
        return self.values

    def row_lengths(self) -> np.ndarray:
        """Number of stored entries per row (matrix-market.cpp:291-307)."""
        return np.bincount(
            self.rows_1based - 1, minlength=self.num_rows
        ).astype(INDEX_DTYPE)

    def max_row_length(self) -> int:
        return int(self.row_lengths().max(initial=0))

    # -- transforms -----------------------------------------------------

    def sorted_row_major(self) -> "MatrixMarket":
        """Stable sort of entries by (row, column) (matrix-market.cpp:897)."""
        order = np.lexsort((self.cols_1based, self.rows_1based))
        return self._permuted_entries(order)

    def sorted_column_major(self) -> "MatrixMarket":
        order = np.lexsort((self.rows_1based, self.cols_1based))
        return self._permuted_entries(order)

    def _permuted_entries(self, order: np.ndarray) -> "MatrixMarket":
        return dataclasses.replace(
            self,
            rows_1based=self.rows_1based[order],
            cols_1based=self.cols_1based[order],
            values=self.values[order],
            values_imag=(
                None if self.values_imag is None else self.values_imag[order]
            ),
        )

    def permute(self, new_order: np.ndarray) -> "MatrixMarket":
        """Symmetric relabeling: entry (i, j) -> (p[i], p[j]).

        Matches matrix_market::Matrix::permute (matrix-market.cpp:309-333):
        ``new_order`` is a 0-based old->new index map over a square matrix.
        """
        p = np.asarray(new_order)
        if self.num_rows != self.num_columns or p.size != self.num_rows:
            raise MatrixError(
                "permute requires a square matrix and a full permutation"
            )
        return dataclasses.replace(
            self,
            rows_1based=(p[self.rows_1based - 1] + 1).astype(INDEX_DTYPE),
            cols_1based=(p[self.cols_1based - 1] + 1).astype(INDEX_DTYPE),
        )

    def expand_symmetry(self) -> "MatrixMarket":
        """Expand symmetric storage to general form.

        A capability the reference lacks (its symmetric files yield only
        the stored triangle; SURVEY.md section 2, L2a notes).  Duplicates
        every off-diagonal entry with indices swapped; skew-symmetric
        negates the mirrored value.
        """
        if self.symmetry == "general":
            return self
        offdiag = self.rows_1based != self.cols_1based
        mr = self.cols_1based[offdiag]
        mc = self.rows_1based[offdiag]
        mv = self.values[offdiag]
        if self.symmetry == "skew-symmetric":
            mv = -mv
        mvi = None
        if self.values_imag is not None:
            mvi = self.values_imag[offdiag]
            if self.symmetry == "hermitian":
                mvi = -mvi
            elif self.symmetry == "skew-symmetric":
                mvi = -mvi
            mvi = np.concatenate([self.values_imag, mvi])
        return dataclasses.replace(
            self,
            symmetry="general",
            num_entries=self.num_entries + int(offdiag.sum()),
            rows_1based=np.concatenate([self.rows_1based, mr]),
            cols_1based=np.concatenate([self.cols_1based, mc]),
            values=np.concatenate([self.values, mv]),
            values_imag=mvi,
        )


def _parse_header(line: str) -> tuple:
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixError(f"invalid Matrix Market header: {line!r}")
    _, obj, fmt, field, symmetry = (p.lower() for p in parts)
    if obj not in _OBJECTS:
        raise MatrixError(f"unsupported object: {obj!r}")
    if fmt not in _FORMATS:
        raise MatrixError(f"unsupported format: {fmt!r}")
    if field not in _FIELDS:
        raise MatrixError(f"unsupported field: {field!r}")
    if symmetry not in _SYMMETRIES:
        raise MatrixError(f"unsupported symmetry: {symmetry!r}")
    if field == "double":
        field = "real"
    return obj, fmt, field, symmetry


def parse_matrix_market(
    text: Union[str, bytes],
    expand_symmetry: bool = False,
) -> MatrixMarket:
    """Parse a Matrix Market document from a string or bytes."""
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="replace")

    pos = 0
    n = len(text)

    def next_line() -> str:
        nonlocal pos
        if pos >= n:
            raise MatrixError("unexpected end of Matrix Market file")
        end = text.find("\n", pos)
        if end == -1:
            end = n
        line = text[pos:end]
        pos = end + 1
        return line

    header = next_line()
    obj, fmt, field, symmetry = _parse_header(header)

    comments = []
    while True:
        line = next_line()
        stripped = line.strip()
        if stripped.startswith("%"):
            comments.append(line)
            continue
        if stripped:
            break
    size_parts = stripped.split()

    if fmt == "coordinate":
        if len(size_parts) != 3:
            raise MatrixError(f"invalid size line: {stripped!r}")
        try:
            num_rows, num_cols, num_entries = (int(p) for p in size_parts)
        except ValueError as e:
            raise MatrixError(f"invalid size line: {stripped!r}") from e
        if num_rows < 0 or num_cols < 0 or num_entries < 0:
            raise MatrixError("negative dimensions in size line")
    else:  # array
        if len(size_parts) != 2:
            raise MatrixError(f"invalid size line: {stripped!r}")
        num_rows, num_cols = (int(p) for p in size_parts)
        num_entries = num_rows * num_cols
    # Indices are stored int32 (the reference's index_type); reject
    # dimensions that would silently wrap (matrix-market.cpp:458-479).
    if num_rows > np.iinfo(INDEX_DTYPE).max \
            or num_cols > np.iinfo(INDEX_DTYPE).max:
        raise MatrixError(
            "matrix dimensions exceed the int32 index range"
        )

    body = text[pos:]

    if fmt == "array":
        # Non-general array files store only the lower triangle,
        # column-major: rows j..n per column (j+1..n for
        # skew-symmetric, whose diagonal is implicit zero) — MM spec
        # section on array symmetry.
        per = 2 if field == "complex" else 1
        if symmetry == "general":
            num_entries = num_rows * num_cols
        else:
            if num_rows != num_cols:
                raise MatrixError(
                    f"{symmetry} array matrices must be square"
                )
            if symmetry == "skew-symmetric":
                num_entries = num_rows * (num_rows - 1) // 2
            else:
                num_entries = num_rows * (num_rows + 1) // 2
        raw = _tokens_to_floats(body)
        if raw.size != num_entries * per:
            raise MatrixError(
                f"expected {num_entries * per} array values, got "
                f"{raw.size}"
            )
        vals = raw[0::per]
        imag = raw[1::per].astype(VALUE_DTYPE) if per == 2 else None
        if symmetry == "general":
            cols, rows = np.meshgrid(
                np.arange(1, num_cols + 1), np.arange(1, num_rows + 1)
            )
            rr = rows.T.ravel()
            cc = cols.T.ravel()
        else:
            lo = 1 if symmetry == "skew-symmetric" else 0
            n = num_rows
            cc = np.repeat(
                np.arange(1, n + 1),
                np.arange(n, 0, -1) - lo,
            )
            rr = np.concatenate(
                [np.arange(j + lo, n + 1) for j in range(1, n + 1)]
            ) if n else np.zeros(0, dtype=np.int64)
        mm = MatrixMarket(
            obj, fmt, field, symmetry, num_rows, num_cols, num_entries,
            np.asarray(rr).astype(INDEX_DTYPE),
            np.asarray(cc).astype(INDEX_DTYPE),
            vals.astype(VALUE_DTYPE), imag, tuple(comments),
        )
        return mm.expand_symmetry() if expand_symmetry else mm

    tokens_per_entry = {"real": 3, "integer": 3, "pattern": 2, "complex": 4}[
        field
    ]
    data = _tokens_to_floats(body)
    if data.size < num_entries * tokens_per_entry:
        raise MatrixError(
            f"expected {num_entries} entries "
            f"({num_entries * tokens_per_entry} fields), "
            f"got {data.size} fields"
        )
    data = data[: num_entries * tokens_per_entry].reshape(
        num_entries, tokens_per_entry
    )
    rows_1 = data[:, 0].astype(np.int64)
    cols_1 = data[:, 1].astype(np.int64)
    if num_entries and (
        rows_1.min(initial=1) < 1
        or cols_1.min(initial=1) < 1
        or rows_1.max(initial=1) > num_rows
        or cols_1.max(initial=1) > num_cols
    ):
        raise MatrixError("matrix entry index out of bounds")
    values_imag = None
    if field == "pattern":
        values = np.ones(num_entries, dtype=VALUE_DTYPE)
    elif field == "complex":
        values = data[:, 2].astype(VALUE_DTYPE)
        values_imag = data[:, 3].astype(VALUE_DTYPE)
    else:
        values = data[:, 2].astype(VALUE_DTYPE)

    mm = MatrixMarket(
        obj, fmt, field, symmetry, num_rows, num_cols, num_entries,
        rows_1.astype(INDEX_DTYPE), cols_1.astype(INDEX_DTYPE),
        values, values_imag, tuple(comments),
    )
    return mm.expand_symmetry() if expand_symmetry else mm


def _tokens_to_floats(body: str) -> np.ndarray:
    """Whitespace-split the entry body into a flat float64 array."""
    # np.fromstring(sep=' ') is deprecated; split+array is the fastest
    # pure-numpy path.  The native C++ parser (csrc/) is the perf path
    # for very large files.
    toks = body.split()
    if not toks:
        return np.empty(0, dtype=VALUE_DTYPE)
    try:
        return np.array(toks, dtype=VALUE_DTYPE)
    except ValueError as e:
        raise MatrixError(f"invalid numeric data in matrix body: {e}") from e


_SUFFIX_RE = re.compile(r"(?P<base>.*?)(?:__(?P<kind>RCM|GP(?P<parts>\d*)))?$")


def load_matrix(
    path: Union[str, os.PathLike],
    expand_symmetry: bool = False,
    verbose: bool = False,
) -> MatrixMarket:
    """Load a Matrix Market file, handling compression and reordering.

    Path dispatch mirrors matrix_market::load_matrix
    (matrix-market.cpp:777-861):

    - a ``__RCM`` suffix applies Reverse Cuthill-McKee reordering, a
      ``__GP<n>`` suffix applies graph-partition reordering into n parts
      (782-801),
    - ``.tar.gz`` / ``.tgz``: SuiteSparse tarball, member
      ``<stem>/<stem>.mtx`` (753-775),
    - ``.gz``: gzip-compressed ``.mtx``,
    - anything else: plain text.
    """
    path = os.fspath(path)

    m = _SUFFIX_RE.fullmatch(path)
    reorder = None
    num_parts = 16
    if m and m.group("kind"):
        kind = m.group("kind")
        path = m.group("base")
        if kind == "RCM":
            reorder = "rcm"
        else:
            reorder = "gp"
            if m.group("parts"):
                num_parts = int(m.group("parts"))

    mm = None
    # Large files go through the native C++ parser (zlib + ustar +
    # strtod fast path, csrc/mmparse.cpp) when it is available; control
    # with SPMV_TPU_NATIVE_INGEST = auto (default) | always | never.
    # Any native failure falls back to the Python parser.
    mode = os.environ.get("SPMV_TPU_NATIVE_INGEST", "auto")
    if mode != "never":
        threshold = 0 if mode == "always" else NATIVE_INGEST_THRESHOLD
        try:
            big = os.path.getsize(path) >= threshold
        except OSError:
            big = False
        if big:
            from spmv_tpu_torch.io import native as _native

            if _native.available():
                try:
                    mm = _native.load_matrix_native(
                        path, expand_symmetry=expand_symmetry
                    )
                    if verbose:
                        print(
                            f"parsed {path} with the native parser",
                            file=sys.stderr,
                        )
                except MatrixError:
                    if mode == "always":
                        raise
                    mm = None

    if mm is None:
        if path.endswith((".tar.gz", ".tgz")):
            stem = os.path.basename(path)
            for ext in (".tar.gz", ".tgz"):
                if stem.endswith(ext):
                    stem = stem[: -len(ext)]
            member = f"{stem}/{stem}.mtx"
            with tarfile.open(path, "r:gz") as tf:
                try:
                    fobj = tf.extractfile(member)
                except KeyError:
                    fobj = None
                if fobj is None:
                    # Fall back to the first .mtx member.
                    names = [
                        n for n in tf.getnames() if n.endswith(".mtx")
                    ]
                    if not names:
                        raise MatrixError(f"no .mtx member in {path}")
                    fobj = tf.extractfile(names[0])
                text = fobj.read()
        elif path.endswith(".gz"):
            with gzip.open(path, "rb") as f:
                text = f.read()
        else:
            with open(path, "rb") as f:
                text = f.read()

        mm = parse_matrix_market(text, expand_symmetry=expand_symmetry)

    if reorder is not None:
        from spmv_tpu_torch.models.reorder import (
            find_new_order_rcm,
            find_new_order_gp,
        )

        if reorder == "rcm":
            order = find_new_order_rcm(mm)
        else:
            order = find_new_order_gp(mm, num_parts=num_parts)
        mm = mm.permute(order)
    return mm


def write_matrix_market(mm: MatrixMarket, path_or_stream) -> None:
    """Serialize a MatrixMarket object back to .mtx text.

    The reference only reads Matrix Market; writing closes the loop for
    generating test fixtures and exporting reordered matrices.  Output
    is always ``coordinate real general``: a still-folded
    symmetric/skew/hermitian matrix is expanded first so the mirrored
    half is not silently dropped on round trip.
    """
    if mm.symmetry != "general":
        mm = mm.expand_symmetry()
    own = isinstance(path_or_stream, (str, bytes))
    stream = open(path_or_stream, "w") if own else path_or_stream
    try:
        stream.write("%%MatrixMarket matrix coordinate real general\n")
        for comment in mm.comments:
            # Parsed comments keep their leading '%'; don't double it.
            stream.write(
                f"{comment}\n" if comment.startswith("%")
                else f"%{comment}\n"
            )
        stream.write(
            f"{mm.num_rows} {mm.num_columns} {mm.num_entries}\n"
        )
        for r, c, v in zip(mm.rows_1based, mm.cols_1based, mm.values):
            stream.write(f"{int(r)} {int(c)} {float(v)!r}\n")
    finally:
        if own:
            stream.close()
