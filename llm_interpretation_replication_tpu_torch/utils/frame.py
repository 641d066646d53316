"""The few table operations the survey and analysis modules need, on row
lists and numpy, computed as pandas computes them.

A table is ``(columns, rows)``: the column names in order and one dict a
row holding every column (``nan`` for an empty cell).  Nothing here is a
general DataFrame; each function is what one or more call sites of the
JAX package's pandas code need:

    read_csv(path, skiprows=0) -> (columns, rows)      # pd.read_csv
    to_numeric(values)                                  # errors="coerce"
    unique(values)                                      # Series.unique
    value_counts(values)                                # Series.value_counts
    pivot_mean(rows, index, columns, values)            # pivot_table
                                        # -> (index, columns, matrix), a Pivot
    pairwise_corr(matrix)                               # DataFrame.corr
    inner_merge(left, right, on, suffixes)              # pd.merge
    records(rows)                                       # DataFrame(rows)
    write_csv(columns, rows, path)                      # .to_csv(index=False)
    to_string(columns, rows, index=True)                # DataFrame.to_string

Means of groups sum with Kahan's compensation, as pandas' grouped mean
does; ``.std()`` is numpy's with ``ddof=1`` (the same two-pass sums as
pandas' ``nanvar``).
"""

from __future__ import annotations

import csv
import math
import numbers
import os
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

Table = Tuple[List[str], List[Dict]]


class Pivot(NamedTuple):
    """A pivot table: sorted row and column labels and the float matrix."""

    index: List
    columns: List
    values: np.ndarray

#: the strings ``pd.read_csv`` reads as NaN by default
#: (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])
_INT = re.compile(r"^\s*[+-]?\d+\s*$")

NAN = float("nan")


def is_na(v) -> bool:
    """``pd.isna`` of a scalar: None or a float NaN."""
    return v is None or (isinstance(v, float) and v != v)


def _is_real(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


# -- reading ---------------------------------------------------------------------------

_POW10 = [float(f"1e{i}") for i in range(309)]
_SPACE = " \t\n\v\f\r"
_INF = {"inf": math.inf, "+inf": math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-inf": -math.inf, "-infinity": -math.inf}


def _xstrtod(s: str) -> Optional[float]:
    """pandas' ``precise_xstrtod`` (the C parser's and ``to_numeric``'s
    float reader): at most 17 significant digits, leading zeros among
    them, accumulated in a double and scaled once by a power of ten; so a
    17-digit ``repr`` may read back one unit off in its last place, as
    pandas reads it.  None where the text is not a number."""
    p, n = 0, len(s)
    while p < n and s[p] in _SPACE:
        p += 1
    neg = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and "0" <= s[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while digits < 17 and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        if digits >= 17:
            while p < n and "0" <= s[p] <= "9":
                p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if neg:
        number = -number
    if p < n and s[p] in "eE":
        q = p + 1
        eneg = q < n and s[q] == "-"
        if q < n and s[q] in "+-":
            q += 1
        e, edigits = 0, 0
        while edigits < 17 and q < n and "0" <= s[q] <= "9":
            e = e * 10 + (ord(s[q]) - 48)
            edigits += 1
            q += 1
        if edigits:
            exponent += -e if eneg else e
            p = q
    if exponent > 308:
        return None
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    if math.isinf(number):
        return None
    while p < n and s[p] in _SPACE:
        p += 1
    return number if p == n else None


def _parse_float(text: str) -> Optional[float]:
    f = _xstrtod(text)
    if f is None:
        return _INF.get(text.lower())
    return f


def _infer(values: List[str]) -> List:
    """One column's cells (None for NA) typed as the C parser types them:
    int64 when every cell is an integer, float64 when every cell is a
    number or NA, bool when every cell is True/False, else strings (an
    NA cell is NaN in each)."""
    present = [v for v in values if v is not None]
    if not present:
        return [NAN] * len(values)
    if all(_INT.match(v) for v in present):
        ints = [int(v) for v in present]
        if len(present) == len(values) and all(-2**63 <= i < 2**63 for i in ints):
            return [int(v) for v in values]
        return [NAN if v is None else float(int(v)) for v in values]
    floats = []
    for v in present:
        f = _parse_float(v)
        if f is None:
            break
        floats.append(f)
    else:
        it = iter(floats)
        return [NAN if v is None else next(it) for v in values]
    if all(v in _TRUE or v in _FALSE for v in present):
        return [NAN if v is None else v in _TRUE for v in values]
    return [NAN if v is None else v for v in values]


def _mangle(header: List[str]) -> List[str]:
    """Duplicate names become ``name.1``, ``name.2``, ... as pandas does."""
    seen: Dict[str, int] = {}
    out = []
    for i, name in enumerate(header):
        name = name if name != "" else f"Unnamed: {i}"
        if name in seen:
            n = seen[name]
            new = f"{name}.{n}"
            while new in seen:
                n += 1
                new = f"{name}.{n}"
            seen[name] = n + 1
            seen[new] = 1
            name = new
        else:
            seen[name] = 1
        out.append(name)
    return out


def read_csv(path: str, skiprows: int = 0) -> Table:
    """``pd.read_csv(path, skiprows=skiprows)`` as ``(columns, rows)``:
    quoted fields may hold commas, quotes and line breaks; blank lines
    are skipped; pandas' default NA strings read NaN; each column is typed
    on the whole of it (header rows under the first included)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        records = [r for r in csv.reader(f) if r]
    records = records[skiprows:]
    if not records:
        raise ValueError(f"no columns to parse from {path}")
    columns = _mangle(list(records[0]))
    width = len(columns)
    cells = [[None if (i >= len(r) or r[i] in NA_STRINGS) else r[i]
              for r in records[1:]] for i in range(width)]
    typed = [_infer(col) for col in cells]
    return columns, [dict(zip(columns, vals)) for vals in zip(*typed)]


def to_numeric(values: Sequence) -> List:
    """``pd.to_numeric(values, errors="coerce")``: numbers and numeric
    strings parse, anything else is NaN; the result is all ints when
    every value is an integer (and none is NaN), else all floats."""
    out = []
    for v in values:
        if isinstance(v, bool):
            out.append(int(v))
        elif _is_real(v):
            out.append(v)
        elif isinstance(v, str):
            if _INT.match(v) and -2**63 <= int(v) < 2**63:
                out.append(int(v))
            else:
                f = _parse_float(v.strip())
                out.append(NAN if f is None else f)
        else:
            out.append(NAN)
    if all(isinstance(v, numbers.Integral) for v in out):
        return [int(v) for v in out]
    return [float(v) for v in out]


def column(rows: Sequence[Dict], name: str) -> List:
    return [r[name] for r in rows]


def dropna(values: Sequence) -> List:
    return [v for v in values if not is_na(v)]


def unique(values: Sequence) -> List:
    """``Series.unique()``: first-seen order, one NaN."""
    seen, out, nan_seen = set(), [], False
    for v in values:
        if is_na(v):
            if not nan_seen:
                nan_seen = True
                out.append(v)
            continue
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def value_counts(values: Sequence) -> List[Tuple[object, int]]:
    """``Series.value_counts()``: (value, count) pairs, NA dropped, by
    count descending, ties in first-seen order (pandas' stable sort)."""
    keys = unique(dropna(values))
    counts: Dict = {k: 0 for k in keys}
    for v in values:
        if not is_na(v):
            counts[v] += 1
    return sorted(((k, counts[k]) for k in keys), key=lambda kc: -kc[1])


def sort_desc(keys: Sequence[float]) -> List[int]:
    """The row order ``sort_values(key, ascending=False)`` gives (pandas'
    ``nargsort`` with its default quicksort; NaN keys last, in order)."""
    items = np.asarray(keys, dtype=float)
    mask = np.isnan(items)
    idx = np.arange(len(items))
    non_nans, non_nan_idx = items[~mask][::-1], idx[~mask][::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return [int(i) for i in np.concatenate([order, np.nonzero(mask)[0]])]


def std(values, ddof: int = 1) -> float:
    """``Series.std(ddof)`` of NaN-free values (NaN with fewer than
    ``ddof + 1`` of them)."""
    arr = np.asarray(values, dtype=float)
    if arr.size <= ddof:
        return NAN
    return float(arr.std(ddof=ddof))


def median(values) -> np.float64:
    """``Series.median()`` of NaN-free values (a numpy float, as pandas
    returns it; NaN if there are none)."""
    arr = np.asarray(values, dtype=float)
    return np.median(arr) if arr.size else np.float64(NAN)


# -- pivots and correlations -------------------------------------------------------------

def _sort_key(v):
    return (0, v) if _is_real(v) else (1, str(v))


def _kahan_mean(values: Sequence[float]) -> float:
    """The mean pandas' grouped ``mean`` takes: a Kahan-compensated sum
    over the non-NaN values in order, over their count (NaN if none)."""
    total = comp = 0.0
    n = 0
    for v in values:
        if v != v:
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / n if n else NAN


def pivot_mean(rows: Sequence[Dict], index: str, columns: str,
               values: str) -> Tuple[List, List, np.ndarray]:
    """``pivot_table(index=, columns=, values=)`` at its defaults as
    ``(index_labels, column_labels, matrix)``: the mean of each cell's
    non-NaN values, sorted labels, cells without a value NaN, and labels
    whose cells are all NaN left out."""
    cells: Dict[Tuple, List[float]] = {}
    for r in rows:
        i, c, v = r[index], r[columns], r[values]
        if is_na(i) or is_na(c):
            continue
        cells.setdefault((i, c), []).append(NAN if is_na(v) else float(v))
    means = {k: _kahan_mean(v) for k, v in cells.items()}
    means = {k: m for k, m in means.items() if m == m}
    rlabels = sorted({k[0] for k in means}, key=_sort_key)
    clabels = sorted({k[1] for k in means}, key=_sort_key)
    rpos = {k: j for j, k in enumerate(rlabels)}
    cpos = {k: j for j, k in enumerate(clabels)}
    mat = np.full((len(rlabels), len(clabels)), np.nan)
    for (i, c), m in means.items():
        mat[rpos[i], cpos[c]] = m
    return rlabels, clabels, mat


#: below this many pair-row steps ``pairwise_corr`` runs pandas' own
#: algorithm (bit-equal); above it, exact sums where the values allow
WELFORD_MAX_STEPS = 250_000


def _welford_corr(mat: np.ndarray) -> np.ndarray:
    """pandas' ``nancorr`` (Welford's method, pairwise complete rows,
    ``min_periods=1``), each step over every column pair at once."""
    n_rows, k = mat.shape
    ok = np.isfinite(mat)
    shape = (k, k)
    nobs = np.zeros(shape)
    meanx = np.zeros(shape)
    meany = np.zeros(shape)
    ssqx = np.zeros(shape)
    ssqy = np.zeros(shape)
    cov = np.zeros(shape)
    for i in range(n_rows):
        both = ok[i][:, None] & ok[i][None, :]
        if not both.any():
            continue
        vx = np.broadcast_to(np.where(ok[i], mat[i], 0.0)[:, None], shape)
        vy = np.broadcast_to(np.where(ok[i], mat[i], 0.0)[None, :], shape)
        n1 = nobs + 1.0
        dx = vx - meanx
        dy = vy - meany
        mx = meanx + 1.0 / n1 * dx
        my = meany + 1.0 / n1 * dy
        sx = ssqx + (vx - mx) * dx
        sy = ssqy + (vy - my) * dy
        cv = cov + (vx - mx) * dy
        nobs = np.where(both, n1, nobs)
        meanx = np.where(both, mx, meanx)
        meany = np.where(both, my, meany)
        ssqx = np.where(both, sx, ssqx)
        ssqy = np.where(both, sy, ssqy)
        cov = np.where(both, cv, cov)
    divisor = np.sqrt(ssqx * ssqy)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.clip(cov / divisor, -1.0, 1.0)
    out[(divisor == 0) | (nobs < 1)] = np.nan
    # pandas fills the lower triangle from the (xi >= yi) computation
    lower = np.tril(np.ones(shape, dtype=bool))
    return np.where(lower, out, out.T)


def _integer_scale(mat: np.ndarray) -> Optional[int]:
    """A scale s in (1, 100) at which every finite value is an integer k
    stored exactly as ``k / s`` (slider answers over 100), small enough
    for sums of products to stay exact in float64; else None."""
    vals = mat[np.isfinite(mat)]
    for s in (1, 100):
        k = np.rint(vals * s)
        if np.array_equal(k / s if s != 1 else k, vals) and \
                (not k.size or np.abs(k).max() <= 2 ** 12):
            return s
    return None


def _exact_corr(mat: np.ndarray, scale: int,
                weights: Optional[np.ndarray]) -> np.ndarray:
    """Pearson over pairwise complete rows from exact integer sums (every
    partial sum below 2**53), rounded once at the end; a pair whose
    values do not vary is NaN, as pandas gives."""
    ok = np.isfinite(mat)
    k_cols = mat.shape[1]
    ints = np.where(ok, np.rint(np.where(ok, mat, 0.0) * scale), 0.0)
    w = (np.ones(mat.shape[0]) if weights is None
         else np.asarray(weights, float))[:, None]
    present = ok.astype(float)
    # one product for the masked count, sum and sum of squares of every
    # column a over the rows where column b is present
    stacked = np.concatenate([present, ints, ints * ints], axis=1).T
    sums = stacked @ (present * w)
    n, sx, sxx = (sums[i * k_cols:(i + 1) * k_cols] for i in range(3))
    sxy = ints.T @ (ints * w)
    vx = n * sxx
    vx -= sx * sx
    num = n * sxy
    num -= sx * sx.T
    div = vx * vx.T
    np.sqrt(div, out=div)
    bad = (div == 0) | (n < 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        np.divide(num, div, out=num)
    np.clip(num, -1.0, 1.0, out=num)
    num[bad] = np.nan
    return num


def pairwise_corr(matrix, rows: Optional[Sequence[int]] = None) -> np.ndarray:
    """``DataFrame(matrix).iloc[rows].corr(method="pearson")``: every
    column pair over the rows where both are present, NaN where a side does
    not vary.  ``rows`` (a resample's row draws, repeats allowed) defaults
    to every row in order.

    Small matrices run pandas' own algorithm on the drawn rows in their
    order (bit-equal); large ones whose values are integers over 1 or 100
    run exact integer sums with masked matrix products, each drawn row
    weighted by its count (within 1e-12 relative of pandas, and NaN
    exactly where pandas has NaN)."""
    mat = np.asarray(matrix, dtype=float)
    steps = (mat.shape[0] if rows is None else len(rows)) * mat.shape[1] ** 2
    scale = _integer_scale(mat) if steps > WELFORD_MAX_STEPS else None
    if scale is not None:
        weights = None if rows is None else np.bincount(
            np.asarray(rows), minlength=mat.shape[0])
        return _exact_corr(mat, scale, weights)
    return _welford_corr(mat if rows is None else mat[np.asarray(rows)])


# -- merging and frames ----------------------------------------------------------------------

def inner_merge(left: Sequence[Dict], right: Sequence[Dict], on: str,
                suffixes: Tuple[str, str] = ("_x", "_y")) -> List[Dict]:
    """``pd.merge(left, right, on=on, suffixes=suffixes)`` (an inner join):
    keys in the left's first-seen order, each key's left rows in order
    with each of its right rows in order; shared columns take the
    suffixes."""
    lcols = list(left[0]) if left else []
    rcols = list(right[0]) if right else []
    shared = (set(lcols) & set(rcols)) - {on}
    by_key: Dict = {}
    for r in right:
        by_key.setdefault(r[on], []).append(r)
    groups: Dict = {}
    for r in left:
        if r[on] in by_key:
            groups.setdefault(r[on], []).append(r)
    out = []
    for key, lrows in groups.items():
        for lr in lrows:
            for rr in by_key[key]:
                row = {on: key}
                for c in lcols:
                    if c != on:
                        row[c + suffixes[0] if c in shared else c] = lr[c]
                for c in rcols:
                    if c != on:
                        row[c + suffixes[1] if c in shared else c] = rr[c]
                out.append(row)
    return out


def _dtype(values: Sequence) -> str:
    """The dtype ``pd.DataFrame`` gives a column of Python values: 'int',
    'float', 'bool', 'str' (strings and NA) or 'object'."""
    present = [v for v in values if not is_na(v)]
    if not present:
        return "float" if values and all(
            isinstance(v, float) for v in values) else "object"
    if all(isinstance(v, bool) for v in present):
        return "bool" if len(present) == len(values) else "object"
    if all(_is_real(v) for v in present):
        if len(present) == len(values) and all(
                isinstance(v, numbers.Integral) for v in present):
            return "int"
        return "float"
    if all(isinstance(v, str) for v in present):
        return "str"
    return "object"


def records(rows: Sequence[Dict],
            columns: Optional[Sequence[str]] = None) -> Table:
    """``pd.DataFrame(rows)`` (then ``.to_dict("records")``) on row dicts:
    the columns are ``columns`` or the keys in first-seen order, a missing
    key is NaN, a column of numbers holding an NA or a float is all
    floats, and a column of strings reads NaN for its NA cells (a column
    of mixed types keeps None)."""
    if columns is None:
        columns = []
        for r in rows:
            for c in r:
                if c not in columns:
                    columns.append(c)
    columns = list(columns)
    out = [{c: r.get(c, NAN) for c in columns} for r in rows]
    for c in columns:
        kind = _dtype([r[c] for r in out])
        if kind in ("float", "str"):
            for r in out:
                v = r[c]
                r[c] = NAN if is_na(v) else (float(v) if kind == "float" else v)
    return columns, out


def _csv_column(values: Sequence) -> List[str]:
    """One column's fields as pandas writes them: a column of numbers with a
    float or an empty cell is float64, every value in ``repr`` (an int
    reads ``1.0``); a column of ints only keeps them; any other column is
    object, each value in ``str``.  An empty cell (None, NaN) is empty."""
    present = [v for v in values if not is_na(v)]
    as_float = (all(_is_real(v) for v in present) and len(present) > 0
                and (len(present) < len(values)
                     or any(not isinstance(v, numbers.Integral) for v in present)))
    return ["" if is_na(v) else repr(float(v)) if as_float else str(v)
            for v in values]


def write_csv(columns: Sequence[str], rows: Sequence[Dict], path: str) -> None:
    """Write ``rows`` (dicts holding every column) to ``path`` as
    ``pandas.DataFrame(rows)[columns].to_csv(path, index=False)`` does:
    comma-separated, ``\\n`` line ends, fields quoted only where they hold a
    comma, a quote or a line break (quotes doubled), floats in their
    shortest round-trip form, ``True``/``False``, empty cells empty."""
    cols = [_csv_column([r[c] for r in rows]) for c in columns]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows(zip(*cols))


# -- DataFrame.to_string -----------------------------------------------------------------------

_DECIMAL = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _trim_zeros(strs: List[str]) -> List[str]:
    def num(x):
        return _DECIMAL.match(x) is not None

    while True:
        nums = [x for x in strs if num(x)]
        if not nums or not all(x.endswith("0") for x in nums):
            break
        strs = [x[:-1] if num(x) else x for x in strs]
    return [x + "0" if num(x) and x.endswith(".") else x for x in strs]


def _float_strings(values: Sequence[float], leading: bool) -> List[str]:
    """pandas' ``FloatArrayFormatter`` at precision 6."""
    sign = " " if leading else ""

    def fmt(spec):
        return ["NaN" if v != v else format(v, sign + spec) for v in values]

    out = _trim_zeros(fmt(".6f"))
    maxlen = max((len(x) for x in out), default=0)
    finite = [abs(v) for v in values if v == v]
    large = any(a > 1e6 for a in finite)
    small = any(0 < a < 1e-6 for a in finite)
    if small or (maxlen > 12 and large):
        out = fmt(".6e")
    return out


def _pprint(v) -> str:
    if v is None:
        return "None"
    if isinstance(v, float) and v != v:
        return "NaN"
    return str(v).replace("\t", "\\t").replace("\r", "\\r").replace("\n", "\\n")


def _object_strings(values: Sequence, leading: bool) -> List[str]:
    """pandas' generic formatter (strings, bools, mixed objects)."""
    out = []
    for v in values:
        if isinstance(v, float) and v == v:
            s = format(v, " .6f").rstrip("0")
            out.append(s + "0" if s.endswith(".") else s)
        else:
            out.append((" " if leading else "") + _pprint(v))
    return out


def to_string(columns: Sequence[str], rows: Sequence[Dict],
              index: bool = True) -> str:
    """``pd.DataFrame(rows, columns=columns).to_string(index=index)`` for
    columns of ints, floats, bools and strings."""
    if not columns:
        return "Empty DataFrame\nColumns: []\nIndex: []"
    if not rows:
        return (f"Empty DataFrame\nColumns: [{', '.join(map(str, columns))}]"
                "\nIndex: []")
    strcols = []
    for c in columns:
        vals = [r[c] for r in rows]
        kind = _dtype(vals)
        if kind == "float" and not vals:
            kind = "object"
        if kind == "float":
            cells = _float_strings([NAN if is_na(v) else float(v)
                                    for v in vals], index)
        elif kind == "int":
            cells = [format(int(v), " d" if index else "d") for v in vals]
        else:
            cells = _object_strings(vals, index)
        header = (" " + str(c)) if kind in ("float", "int", "bool") else str(c)
        width = max(len(header), *(len(x) for x in cells))
        strcols.append([header.rjust(width)] + [x.rjust(width) for x in cells])
    if index:
        labels = [str(i) for i in range(len(rows))]
        width = max(len(x) for x in labels)
        strcols.insert(0, [""] + [x.ljust(width) for x in labels])
    widths = [max(len(x) for x in col) for col in strcols]
    lines = []
    for i in range(len(rows) + 1):
        parts = [col[i].ljust(w + 1) for col, w in zip(strcols[:-1], widths)]
        lines.append("".join(parts) + strcols[-1][i].ljust(widths[-1]))
    return "\n".join(lines)
