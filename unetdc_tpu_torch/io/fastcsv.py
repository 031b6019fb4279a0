"""Fast CSV serialization, byte-identical to ``DataFrame.to_csv(index=False)``.

The reference writes its droplet tables through pandas
(quantify_droplets_batch.py:61-63 per image, :163-167 for the master CSVs),
so the artifact contract is pandas' exact byte format: repr-shortest float64
formatting, csv-module QUOTE_MINIMAL quoting, ``\\n`` line terminator,
NaN -> empty field (quoted when it is the row's only field).

pandas' ``to_csv`` pays milliseconds of per-call machinery even for a
~200-row frame; formatting the same rows with plain ``repr``/``str`` +
``join`` emits the identical bytes, because CPython's ``repr(float)`` and
pandas both write the shortest round-trip decimal. ``to_csv_bytes`` returns
None for any dtype outside that envelope (anything but int/bool/float64/str
columns) and callers fall back to pandas. An own copy of the JAX package's
``io/fastcsv.py``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_NEEDS_QUOTE = (",", '"', "\n", "\r")


def _quote(s: str) -> str:
    """csv-module QUOTE_MINIMAL quoting for one field."""
    if any(c in s for c in _NEEDS_QUOTE):
        return '"' + s.replace('"', '""') + '"'
    return s


def _column_strings(values: np.ndarray) -> Optional[List[str]]:
    """Format one column; None if the dtype is outside the proven envelope."""
    dt = values.dtype
    if dt.kind in ("i", "u"):
        return [str(v) for v in values.tolist()]
    if dt.kind == "b":
        return [str(v) for v in values.tolist()]
    if dt == np.float64:
        # repr(float) == pandas' shortest-roundtrip formatting (incl. 'inf');
        # NaN becomes the empty field like pandas' default na_rep
        return ["" if v != v else repr(v) for v in values.tolist()]
    if dt == object:
        out = []
        for v in values.tolist():
            if not isinstance(v, str):
                return None
            out.append(_quote(v))
        return out
    return None  # float32/datetime/categorical/... -> pandas fallback


def to_csv_bytes(df) -> Optional[bytes]:
    """``df.to_csv(index=False).encode()`` or None if unsupported."""
    if len(df.columns) == 0 or not df.columns.is_unique:
        return None  # zero/duplicate columns: rare — let pandas handle them
    cols: List[List[str]] = []
    for name in df.columns:
        s = _column_strings(df[name].to_numpy())
        if s is None:
            return None
        cols.append(s)
    lines = [",".join(_quote(str(c)) for c in df.columns)]
    if len(cols) == 1:
        # the csv module quotes an empty field when it is the row's only
        # field (to keep the row distinguishable from a blank line)
        lines.extend(v if v else '""' for v in cols[0])
    else:
        lines.extend(",".join(row) for row in zip(*cols))
    return ("\n".join(lines) + "\n").encode("utf-8")


def write_csv(path, df) -> None:
    """Write ``df`` as CSV, bytes-identical to ``to_csv(index=False)``."""
    data = to_csv_bytes(df)
    if data is None:
        df.to_csv(path, index=False)
    else:
        with open(path, "wb") as f:
            f.write(data)
