"""The port's table operations (``utils/frame.py``) against pandas on the
same inputs: ``read_csv`` against ``pd.read_csv`` (every default NA string,
quoted commas and line breaks, Qualtrics' three header rows, int / float /
bool / mixed columns, 17-digit floats, a round trip through
``frame.write_csv``), and each of ``to_numeric``, ``unique``,
``value_counts``, ``pivot_mean``, ``pairwise_corr``, ``inner_merge``,
``records``, ``sort_desc`` and ``to_string`` against the pandas call it
stands for.  Equal means equal values of equal Python types (NaN equal to
NaN); ``pairwise_corr``'s exact path is held at |d| <= 1e-12 |r| + 1e-15
with NaN exactly where pandas has NaN.
"""

import math

import numpy as np
import pandas as pd
import pytest
from pandas._libs.parsers import STR_NA_VALUES

from llm_interpretation_replication_tpu_torch.utils import frame
from test_torch_slots import one_torch_thread  # noqa: F401

SEED = 17


def same_cell(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def assert_same_table(got, ref: pd.DataFrame):
    columns, rows = got
    assert columns == list(ref.columns)
    want = ref.to_dict("records")
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        for c in columns:
            assert same_cell(r[c], w[c]), (c, r[c], w[c])


def write_lines(path, lines):
    with open(path, "w", newline="", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def test_na_strings_are_pandas_defaults():
    assert frame.NA_STRINGS == set(STR_NA_VALUES)


@pytest.mark.parametrize("na", sorted(STR_NA_VALUES))
def test_read_csv_every_default_na_string(tmp_path, na):
    cell = f'"{na}"' if na == "" else na
    path = write_lines(tmp_path / "na.csv", [
        "ints,floats,text,flags", f"1,2.5,a,True", f"{cell},{cell},{cell},{cell}",
        "3,4.0,c,False"])
    assert_same_table(frame.read_csv(path), pd.read_csv(path))


@pytest.mark.parametrize("case", ["typed", "mixed", "quoted", "qualtrics",
                                  "digits", "blank_lines"])
def test_read_csv_matches_pandas(tmp_path, case):
    rng = np.random.default_rng(SEED)
    lines = {
        "typed": ["i,f,b,s,e", "1,1.5,True,x,", "-2,nan,False,y,",
                  " 3 ,1e-3,TRUE,z,", "4,-inf,false,w,"],
        "mixed": ["a,b,c", "1,x,True", "2.5,2,3", "NA,True,False"],
        "quoted": ['id,text', '1,"a, b"', '2,"line one\nline two"',
                   '3,"say ""hi"""', '4,plain'],
        "qualtrics": ["StartDate,Duration (in seconds),Q1_1,Q1_2",
                      'Start Date,Duration (in seconds),"Stem, with a comma'
                      '\nLeft = No, Right = Yes - Is a ""dog"" a pet?",Q - b?',
                      '{"ImportId":"startDate"},{"ImportId":"duration"},'
                      '{"ImportId":"QID1_1"},{"ImportId":"QID1_2"}',
                      "2024-01-01,600,55,",
                      "2024-01-02,,100,3"],
        "digits": ["v,w"] + [f"{rng.normal() * 10.0 ** rng.integers(-8, 8)!r},"
                             f"{rng.integers(-10**6, 10**6)}" for _ in range(40)]
        + ["0.008142180518343508,1", "123456789012345678901,2"],
        "blank_lines": ["a,b", "1,2", "", "3,4", ""],
    }[case]
    path = write_lines(tmp_path / f"{case}.csv", lines)
    assert_same_table(frame.read_csv(path), pd.read_csv(path))
    if case == "qualtrics":
        assert_same_table(frame.read_csv(path, skiprows=1),
                          pd.read_csv(path, skiprows=1))


def test_read_csv_round_trips_write_csv(tmp_path):
    """The port's CSV writer and reader give back what pandas reads from
    the same bytes, 17-digit floats and NaN cells included."""
    rng = np.random.default_rng(SEED)
    rows = [{"p": float(rng.uniform()), "q": int(rng.integers(0, 9)),
             "s": rng.choice(["Yes", "No, not", 'a "q"']),
             "b": bool(rng.integers(0, 2)),
             "n": float("nan") if i % 3 == 0 else float(rng.normal())}
            for i in range(30)]
    path = str(tmp_path / "rt.csv")
    frame.write_csv(list(rows[0]), rows, path)
    got = frame.read_csv(path)
    assert_same_table(got, pd.read_csv(path))
    pd.DataFrame(rows).to_csv(tmp_path / "pd.csv", index=False)
    assert open(path, "rb").read() == open(tmp_path / "pd.csv", "rb").read()


def test_to_numeric_unique_and_value_counts_match_pandas():
    rng = np.random.default_rng(SEED)
    for vals in (["1", "2", "x"], ["1", "2"], [1, 2.5], ["1.5", None, " 3 "],
                 ["inf", "-1e3", "1e5"], [float("nan"), "3"],
                 ["0.008142180518343508", "7"], [True, 2]):
        ref = pd.to_numeric(pd.Series(vals, dtype=object), errors="coerce")
        got = frame.to_numeric(vals)
        assert all(same_cell(a, b) for a, b in zip(got, ref.tolist())), vals
    for _ in range(50):
        n = int(rng.integers(1, 60))
        vals = [str(v) for v in rng.choice(list("abcdefgh"), n)]
        if rng.random() < 0.3:
            vals[int(rng.integers(0, n))] = float("nan")
        s = pd.Series(vals)
        counts = s.value_counts()
        assert frame.value_counts(vals) == list(zip(counts.index, counts.tolist()))
        assert [v for v in frame.unique(vals) if v == v] == \
            [v for v in s.unique().tolist() if v == v]


def test_pivot_mean_matches_pivot_table():
    rng = np.random.default_rng(SEED)
    for _ in range(40):
        rows = [{"p": f"q{int(rng.integers(0, 6))}",
                 "m": f"m{int(rng.integers(0, 4))}",
                 "v": float(rng.normal()) if rng.random() > 0.2 else float("nan")}
                for _ in range(int(rng.integers(1, 50)))]
        ref = pd.DataFrame(rows).pivot_table(index="p", columns="m", values="v")
        index, columns, values = frame.pivot_mean(rows, "p", "m", "v")
        assert (index, columns) == (list(ref.index), list(ref.columns))
        assert np.array_equal(values, ref.to_numpy(), equal_nan=True)


def _slider_matrix(rng, n_rows, n_cols, missing=0.1, constant_col=True):
    m = rng.integers(0, 101, (n_rows, n_cols)) / 100.0
    if constant_col:
        m[:, 0] = 0.5
    m[rng.random(m.shape) < missing] = np.nan
    return m


@pytest.mark.parametrize("resample", [False, True])
def test_pairwise_corr_matches_dataframe_corr(resample):
    """Small matrices: pandas' algorithm on the drawn rows, bit-equal; the
    exact integer path (the survey's hundreds of respondents) within
    1e-12 relative (1e-15 absolute at a zero correlation), NaN where
    pandas has NaN."""
    rng = np.random.default_rng(SEED)
    for t in range(60):
        m = _slider_matrix(rng, int(rng.integers(2, 12)),
                           int(rng.integers(2, 9)), constant_col=t % 3 == 0)
        rows = rng.integers(0, len(m), len(m)) if resample else None
        ref = pd.DataFrame(m if rows is None else m[rows]).corr().to_numpy()
        assert np.array_equal(frame.pairwise_corr(m, rows=rows), ref,
                              equal_nan=True)
        exact = frame._exact_corr(m, 100, None if rows is None else np.bincount(
            rows, minlength=len(m)))
        assert np.array_equal(np.isnan(exact), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert np.all(np.abs(exact[ok] - ref[ok])
                      <= 1e-12 * np.abs(ref[ok]) + 1e-15)


def test_pairwise_corr_takes_the_exact_path_at_survey_size():
    rng = np.random.default_rng(SEED)
    m = _slider_matrix(rng, 10, 300, missing=0.02)
    assert 10 * 300 ** 2 > frame.WELFORD_MAX_STEPS
    got = frame.pairwise_corr(m)
    assert np.array_equal(got, frame._exact_corr(m, 100, None), equal_nan=True)
    ref = pd.DataFrame(m).corr().to_numpy()
    ok = ~np.isnan(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.all(np.abs(got[ok] - ref[ok]) <= 1e-12 * np.abs(ref[ok]) + 1e-15)
    # values that are not integers over 1 or 100 take pandas' algorithm
    assert frame._integer_scale(m + 1e-3) is None
    assert np.array_equal(frame.pairwise_corr(m + 1e-3),
                          pd.DataFrame(m + 1e-3).corr().to_numpy(), equal_nan=True)


def test_inner_merge_records_and_sort_match_pandas():
    left = [{"k": "a", "v": 1}, {"k": "b", "v": 2}, {"k": "a", "v": 3},
            {"k": "c", "v": 4}]
    right = [{"k": "c", "v": 10.5}, {"k": "a", "v": 20.5}, {"k": "a", "v": 30.5}]
    ref = pd.merge(pd.DataFrame(left), pd.DataFrame(right), on="k",
                   suffixes=("_l", "_r")).to_dict("records")
    assert frame.inner_merge(left, right, "k", ("_l", "_r")) == ref
    recs = [{"a": 1, "b": "x"}, {"a": 2, "c": True}, {"b": None, "d": 1.5}]
    columns, rows = frame.records(recs)
    ref = pd.DataFrame(recs)
    assert columns == list(ref.columns)
    for r, w in zip(rows, ref.to_dict("records")):
        assert all(same_cell(r[c], w[c]) or (r[c] is None and w[c] is None)
                   for c in columns)
    rng = np.random.default_rng(SEED)
    for _ in range(100):
        n = int(rng.integers(1, 40))
        k = rng.integers(0, 4, n).astype(float)
        k[rng.random(n) < 0.2] = np.nan
        ref = pd.DataFrame({"k": k, "i": range(n)}).sort_values(
            "k", ascending=False)["i"].tolist()
        assert frame.sort_desc(k) == ref


def test_to_string_matches_pandas():
    rng = np.random.default_rng(SEED)
    checked = 0
    for _ in range(150):
        n = int(rng.integers(1, 6))
        cols = {}
        for j in range(int(rng.integers(1, 5))):
            kind = int(rng.integers(0, 5))
            if kind == 0:
                vals = [int(x) for x in rng.integers(-1000, 100000, n)]
            elif kind == 1:
                vals = [float(x) for x in
                        rng.normal(0, 10.0 ** rng.integers(-9, 9), n)]
                if rng.random() < 0.3:
                    vals[0] = float("nan")
            elif kind == 2:
                vals = [bool(x) for x in rng.integers(0, 2, n)]
            elif kind == 3:
                vals = [str(rng.choice(["a", "bb c", "x/y-z", "tab\tand"]))
                        for _ in range(n)]
            else:
                vals = [round(float(x), int(rng.integers(0, 4)))
                        for x in rng.uniform(0, 1, n)]
            cols[f"c{j}" + "x" * int(rng.integers(0, 12))] = vals
        rows = [{c: v[i] for c, v in cols.items()} for i in range(n)]
        ref = pd.DataFrame(rows)
        for index in (True, False):
            assert frame.to_string(list(cols), rows, index=index) == \
                ref.to_string(index=index)
            checked += 1
    assert checked == 300
    assert frame.to_string([], []) == pd.DataFrame([]).to_string()
