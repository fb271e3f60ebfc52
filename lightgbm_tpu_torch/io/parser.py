"""Text parsers: CSV/TSV/LibSVM with format auto-detection.

A copy of ``lightgbm_tpu/io/parser.py`` for the PyTorch port (which imports
nothing of the JAX package); the counterpart of the reference
``Parser::CreateParser`` (src/io/parser.cpp:1-222): sniff a few lines, pick
the format, parse to a dense float64 matrix.  Every reader keeps both of its
branches: pandas' C reader when pandas is installed, and without it
``np.loadtxt`` (one-shot) or a per-token ``float()`` loop (streaming and
sampled lines), with the same NA tokens; a one-shot file with NA tokens,
which ``np.loadtxt`` refuses, takes the per-token loop too.  A machine without pandas (a card
machine may have none) runs only the second.  LibSVM is parsed directly.
"""
from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

from ..utils.log import Log


def _sniff_lines(path: str, k: int = 32) -> List[str]:
    lines = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip("\r\n")
            if line:
                lines.append(line)
            if len(lines) >= k:
                break
    return lines


def _is_libsvm_token(tok: str) -> bool:
    if ":" not in tok:
        return False
    a, b = tok.split(":", 1)
    try:
        int(a)
        float(b)
        return True
    except ValueError:
        return False


def detect_format(path: str) -> Tuple[str, str]:
    """Return (format, separator): format in {csv, tsv, libsvm}."""
    lines = _sniff_lines(path)
    if not lines:
        Log.fatal("Data file %s is empty", path)
    probe = lines[1] if len(lines) > 1 else lines[0]
    for sep, name in (("\t", "tsv"), (",", "csv"), (" ", "tsv")):
        if sep in probe:
            toks = probe.split(sep)
            if len(toks) > 1:
                if any(_is_libsvm_token(t) for t in toks[1:3]):
                    return "libsvm", " "
                return name, sep
    if _is_libsvm_token(probe.split(" ")[-1]):
        return "libsvm", " "
    return "tsv", "\t"


def _has_header(first_line: str, sep: str) -> bool:
    for tok in first_line.split(sep):
        tok = tok.strip()
        if not tok:
            continue
        try:
            float(tok)
            return False
        except ValueError:
            return True
    return False


def parse_file(path: str, header: Optional[bool] = None,
               label_idx: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """Parse a data file -> (features [N, D], labels [N], column names).

    ``label_idx`` < 0 means no label column in the file.  For LibSVM the
    leading target is the label; feature indices are taken as 0-based columns
    (reference parses both but defaults to the file's own indexing).
    """
    fmt, sep = detect_format(path)
    if fmt == "libsvm":
        return _parse_libsvm(path, label_idx)
    lines = _sniff_lines(path, 1)
    hdr = _has_header(lines[0], sep) if header is None else header
    names = None
    try:
        import pandas as pd
        df = pd.read_csv(path, sep=sep, header=0 if hdr else None,
                         dtype=np.float64 if not hdr else None,
                         na_values=["", "NA", "N/A", "nan", "NaN", "null"])
        if hdr:
            names = [str(c) for c in df.columns]
        mat = df.to_numpy(dtype=np.float64)
    except ImportError:
        skip = 1 if hdr else 0
        if hdr:
            names = lines[0].split(sep)
        try:
            mat = np.loadtxt(path, delimiter=sep if sep != " " else None,
                             skiprows=skip, dtype=np.float64, ndmin=2)
        except ValueError:
            # NA tokens, which np.loadtxt cannot read (the JAX package's
            # branch raises here): the per-token parse of stream_file
            mat = np.concatenate(list(stream_file(path, 1 << 16,
                                                  header=hdr)))
    if label_idx < 0:
        return mat, np.zeros(len(mat)), names
    label = mat[:, label_idx].copy()
    feats = np.delete(mat, label_idx, axis=1)
    if names is not None:
        names = [n for i, n in enumerate(names) if i != label_idx]
    return feats, label, names


def _parse_libsvm(path: str, label_idx: int
                  ) -> Tuple[np.ndarray, np.ndarray, None]:
    labels: List[float] = []
    rows: List[List[Tuple[int, float]]] = []
    max_idx = -1
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            start = 0
            lab = 0.0
            if label_idx >= 0 and toks and ":" not in toks[0]:
                lab = float(toks[0])
                start = 1
            pairs = []
            for tok in toks[start:]:
                if ":" not in tok:
                    continue
                i, v = tok.split(":", 1)
                i = int(i)
                pairs.append((i, float(v)))
                max_idx = max(max_idx, i)
            labels.append(lab)
            rows.append(pairs)
    mat = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
    for r, pairs in enumerate(rows):
        for i, v in pairs:
            mat[r, i] = v
    return mat, np.asarray(labels), None


# ---- streaming (two_round) readers --------------------------------------
# Counterparts of the reference's sampling/streaming text pipeline
# (src/io/dataset_loader.cpp:819 SampleTextDataFromFile + the two_round
# re-read, utils/pipeline_reader.h): pass 1 reservoir-samples rows while
# counting them; pass 2 re-reads the file in bounded chunks.


_NA_TOKENS = {"", "NA", "N/A", "nan", "NaN", "null"}


def sniff_header(path: str):
    """(has_header, column names or None) using the same detection as
    parse_file."""
    fmt, sep = detect_format(path)
    if fmt == "libsvm":
        return False, None
    first = _sniff_lines(path, 1)[0]
    if not _has_header(first, sep):
        return False, None
    return True, [c.strip() for c in first.split(sep)]


def stream_file(path: str, chunk_rows: int = 65536,
                header: "Optional[bool]" = None,
                num_cols: "Optional[int]" = None,
                skip_rows: int = 0, max_rows: "Optional[int]" = None):
    """Yield [m, D] float64 chunks of a text data file (m <= chunk_rows).

    For CSV/TSV, D is the file's column count (label still embedded).  For
    LibSVM, the leading label is column 0 and features occupy columns
    1..num_cols (``num_cols`` from a prior sampling pass is required so
    chunk widths agree).  ``skip_rows``/``max_rows`` select a contiguous
    data-row range (both count non-blank DATA lines, header excluded) —
    the stripe window of a sharded pass 2."""
    fmt, sep = detect_format(path)
    skip_rows = int(skip_rows)
    if fmt == "libsvm":
        if num_cols is None:
            raise ValueError("LibSVM streaming needs num_cols from the "
                             "sampling pass")
        buf_rows: List[List[Tuple[int, float]]] = []
        labels: List[float] = []

        def flush():
            mat = np.zeros((len(buf_rows), num_cols + 1), dtype=np.float64)
            mat[:, 0] = labels
            for r, pairs in enumerate(buf_rows):
                for i, v in pairs:
                    if i < num_cols:
                        mat[r, i + 1] = v
            return mat

        seen = 0
        emitted = 0
        with open(path) as fh:
            for line in fh:
                toks = line.split()
                if not toks:
                    continue
                seen += 1
                if seen <= skip_rows:
                    continue
                if max_rows is not None and emitted >= max_rows:
                    break
                start = 0
                lab = 0.0
                if ":" not in toks[0]:
                    lab = float(toks[0])
                    start = 1
                labels.append(lab)
                buf_rows.append([(int(t.split(":", 1)[0]),
                                  float(t.split(":", 1)[1]))
                                 for t in toks[start:] if ":" in t])
                emitted += 1
                if len(buf_rows) >= chunk_rows:
                    yield flush()
                    buf_rows, labels = [], []
        if buf_rows:
            yield flush()
        return

    lines = _sniff_lines(path, 1)
    hdr = _has_header(lines[0], sep) if header is None else header
    na = ["", "NA", "N/A", "nan", "NaN", "null"]
    try:
        import pandas as pd
        if skip_rows == 0 and max_rows is None:
            # the path goes to pandas, so that its C reader owns the file
            reader = pd.read_csv(
                path, sep=sep, header=0 if hdr else None,
                dtype=np.float64 if not hdr else None,
                na_values=na, chunksize=chunk_rows)
            for df in reader:
                yield df.to_numpy(dtype=np.float64)
            return
        # stripe window: consume the header + skipped data lines by hand
        # (blank-line discipline must match the counting scan), then let
        # the C reader stream the remainder from the open handle
        remaining = max_rows
        if remaining is not None and remaining <= 0:
            return
        with open(path) as fh:
            if hdr:
                fh.readline()
            skipped = 0
            while skipped < skip_rows:
                line = fh.readline()
                if not line:
                    return
                if line.strip():
                    skipped += 1
            try:
                reader = pd.read_csv(fh, sep=sep, header=None,
                                     dtype=np.float64, na_values=na,
                                     chunksize=chunk_rows)
                for df in reader:
                    a = df.to_numpy(dtype=np.float64)
                    if remaining is not None:
                        a = a[:remaining]
                    if len(a):
                        yield a
                    if remaining is not None:
                        remaining -= len(a)
                        if remaining <= 0:
                            break
            except pd.errors.EmptyDataError:
                return
        return
    except ImportError:
        with open(path) as fh:
            if hdr:
                fh.readline()
            rows = []
            seen = 0
            emitted = 0
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                seen += 1
                if seen <= skip_rows:
                    continue
                if max_rows is not None and emitted >= max_rows:
                    break
                rows.append([float("nan") if t in _NA_TOKENS else float(t)
                             for t in line.split(sep)])
                emitted += 1
                if len(rows) >= chunk_rows:
                    yield np.asarray(rows, dtype=np.float64)
                    rows = []
            if rows:
                yield np.asarray(rows, dtype=np.float64)


def sample_stream(path: str, sample_cnt: int, seed: int = 1,
                  chunk_rows: int = 65536, header: "Optional[bool]" = None):
    """Pass 1: stream the file once, reservoir-sampling ``sample_cnt`` rows.

    Returns (sample [k, D] float64, total_rows, num_cols) where num_cols for
    LibSVM is the max feature index + 1 (label at column 0 like the CSV
    layout stream_file produces)."""
    fmt, sep = detect_format(path)
    rng = np.random.RandomState(seed)
    total = 0

    if fmt == "libsvm":
        # single pass: reservoir-sample RAW lines while tracking the width,
        # parse the sampled lines at the end (two file reads total incl. the
        # fill pass, like the reference's sample + re-read)
        max_idx = -1
        line_sample: List[str] = []
        with open(path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                for t in line.split():
                    if ":" in t:
                        i = int(t.split(":", 1)[0])
                        if i > max_idx:
                            max_idx = i
                total += 1
                if len(line_sample) < sample_cnt:
                    line_sample.append(line)
                else:
                    j = rng.randint(0, total)
                    if j < sample_cnt:
                        line_sample[j] = line
        num_cols = max_idx + 1
        mat = np.zeros((len(line_sample), num_cols + 1), dtype=np.float64)
        for r, line in enumerate(line_sample):
            toks = line.split()
            start = 0
            if toks and ":" not in toks[0]:
                mat[r, 0] = float(toks[0])
                start = 1
            for t in toks[start:]:
                if ":" in t:
                    i, v = t.split(":", 1)
                    mat[r, int(i) + 1] = float(v)
        return mat, total, num_cols
    else:
        # CSV/TSV: reservoir-sample RAW LINES and parse only the sample —
        # pass 1 becomes an IO-bound line scan instead of a full-file parse
        # (the full parse happens exactly once, in pass 2).  Mirrors the
        # reference's SampleTextDataFromFile + ParseOneLine split
        # (dataset_loader.cpp sampling path).
        if header is None:
            lines0 = _sniff_lines(path, 1)
            header = _has_header(lines0[0], sep) if lines0 else False
        # block-based line scan: 16 MB reads split in C, reservoir acceptance
        # vectorized per block (a per-line Python loop ran at ~4 us/line).
        # LIMITATION: blocks split on bare \n, so quoted fields containing
        # embedded newlines would corrupt sampled rows AND the row count —
        # matching the reference parser, which is also line-based and has no
        # quote support (src/io/parser.hpp CSVParser::ParseOneLine)
        line_sample = []
        with open(path) as fh:
            if header:
                fh.readline()
            rem = ""
            while True:
                block = fh.read(16 << 20)
                if not block:
                    break
                block = rem + block
                lines = block.split("\n")
                rem = lines.pop()
                lines = [l for l in lines if l.strip()]
                m = len(lines)
                if not m:
                    continue
                take = min(max(sample_cnt - len(line_sample), 0), m)
                line_sample.extend(lines[:take])
                if take < m:
                    pos = total + np.arange(take + 1, m + 1)
                    js = (rng.random_sample(m - take) * pos).astype(np.int64)
                    for r in np.flatnonzero(js < sample_cnt):
                        line_sample[js[r]] = lines[take + r]
                total += m
            if rem.strip():
                total += 1
                if len(line_sample) < sample_cnt:
                    line_sample.append(rem)
                else:
                    j = rng.randint(0, total)
                    if j < sample_cnt:
                        line_sample[j] = rem
        if not line_sample:
            return np.zeros((0, 0), dtype=np.float64), total, 0
        import io as _io
        try:
            import pandas as pd
            df = pd.read_csv(_io.StringIO("\n".join(line_sample)), sep=sep,
                             header=None, dtype=np.float64,
                             na_values=["", "NA", "N/A", "nan", "NaN",
                                        "null"])
            mat = df.to_numpy(dtype=np.float64)
        except ImportError:
            mat = np.asarray(
                [[float("nan") if t in _NA_TOKENS else float(t)
                  for t in line.strip().split(sep)] for line in line_sample],
                dtype=np.float64)
        return mat, total, mat.shape[1]


# ---- hash-priority sampling scan (round-21 streaming/sharded pass 1) -----


def _iter_line_blocks(path: str, header: bool, skip_rows: int = 0,
                      max_rows: "Optional[int]" = None):
    """Yield ``(ordinal, lines)`` blocks of non-blank data lines: 16 MB raw
    reads split in C, header + the first ``skip_rows`` data lines dropped,
    at most ``max_rows`` lines emitted.  ``ordinal`` is the 0-based data-line
    position of ``lines[0]`` WITHIN the emitted window (callers add their
    stripe offset).  Shares sample_stream's line discipline (and its quoted-
    newline limitation, same as the reference's line-based parser)."""
    seen = 0      # non-blank data lines consumed, including skipped ones
    emitted = 0
    skip_rows = int(skip_rows)

    def clip(lines):
        nonlocal seen, emitted
        drop = max(0, skip_rows - seen)
        seen += len(lines)
        kept = lines[drop:]
        if max_rows is not None:
            kept = kept[:max_rows - emitted]
        start = emitted
        emitted += len(kept)
        return start, kept

    with open(path) as fh:
        if header:
            fh.readline()
        rem = ""
        while True:
            block = fh.read(16 << 20)
            if not block:
                break
            block = rem + block
            lines = block.split("\n")
            rem = lines.pop()
            lines = [l for l in lines if l.strip()]
            if not lines:
                continue
            start, kept = clip(lines)
            if kept:
                yield start, kept
            if max_rows is not None and emitted >= max_rows:
                return
        if rem.strip():
            start, kept = clip([rem])
            if kept:
                yield start, kept


def count_data_rows(path: str, header: "Optional[bool]" = None) -> int:
    """Count non-blank data rows without parsing — pass 0 of the sharded
    loader (every rank needs the global row count to know its stripe)."""
    fmt, sep = detect_format(path)
    if fmt == "libsvm":
        hdr = False
    elif header is None:
        lines0 = _sniff_lines(path, 1)
        hdr = _has_header(lines0[0], sep) if lines0 else False
    else:
        hdr = bool(header)
    n = 0
    for _start, lines in _iter_line_blocks(path, hdr):
        n += len(lines)
    return n


def hash_sample_lines(path: str, sample_cnt: int, seed: int,
                      header: "Optional[bool]" = None, skip_rows: int = 0,
                      max_rows: "Optional[int]" = None,
                      base_index: "Optional[int]" = None):
    """Pass 1 of the streaming loader: scan RAW lines of (a stripe of) the
    file, keep the :mod:`sample` hash-priority winners, and parse ONLY the
    winners — sampling costs a line scan, never a full parse.

    Rows are globally indexed ``base_index + ordinal`` (default
    ``skip_rows``, i.e. a stripe of the same file), which is what makes a
    striped scan's winners mergeable into the exact serial sample.
    Returns ``(idx, keys, sample [k, D], rows_scanned, width)`` with the
    sample ascending by global index; ``width`` counts ALL file columns —
    for LibSVM the label column 0 plus ``max_feature_index + 1`` features.
    """
    from .sample import RowSampler
    fmt, sep = detect_format(path)
    if fmt == "libsvm":
        hdr = False
    elif header is None:
        lines0 = _sniff_lines(path, 1)
        hdr = _has_header(lines0[0], sep) if lines0 else False
    else:
        hdr = bool(header)
    base = int(skip_rows) if base_index is None else int(base_index)
    smp = RowSampler(sample_cnt, seed)
    max_idx = -1
    for start, lines in _iter_line_blocks(path, hdr, skip_rows, max_rows):
        if fmt == "libsvm":
            for line in lines:
                for t in line.split():
                    if ":" in t:
                        i = int(t.split(":", 1)[0])
                        if i > max_idx:
                            max_idx = i
        arr = np.empty(len(lines), dtype=object)
        arr[:] = lines
        smp.observe(np.arange(base + start, base + start + len(lines),
                              dtype=np.int64), arr)
    idx, keys, rows = smp.result()
    win_lines = list(rows) if rows is not None else []
    if fmt == "libsvm":
        width = max_idx + 2  # label col 0 + features 1..max_idx+1
        mat = np.zeros((len(win_lines), width), dtype=np.float64)
        for r, line in enumerate(win_lines):
            toks = line.split()
            start0 = 0
            if toks and ":" not in toks[0]:
                mat[r, 0] = float(toks[0])
                start0 = 1
            for t in toks[start0:]:
                if ":" in t:
                    i, v = t.split(":", 1)
                    mat[r, int(i) + 1] = float(v)
        return idx, keys, mat, smp.total, width
    if not win_lines:
        return idx, keys, np.zeros((0, 0), dtype=np.float64), smp.total, 0
    try:
        import pandas as pd
        df = pd.read_csv(io.StringIO("\n".join(win_lines)), sep=sep,
                         header=None, dtype=np.float64,
                         na_values=["", "NA", "N/A", "nan", "NaN", "null"])
        mat = df.to_numpy(dtype=np.float64)
    except ImportError:
        mat = np.asarray(
            [[float("nan") if t in _NA_TOKENS else float(t)
              for t in line.strip().split(sep)] for line in win_lines],
            dtype=np.float64)
    return idx, keys, mat, smp.total, mat.shape[1]
