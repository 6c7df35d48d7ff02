"""Real-corpus parsers: capability port of the reference dataset layer.

The port's copy of ``sprintz_tpu/data/loaders.py`` (numpy, host): the same
parsers, giving the same arrays.

The reference evaluates on five corpora (SURVEY §2.14); its loaders live
in the reference's python/datasets/ (ucr.py:44-181, msrc.py, pamap2.py,
ampds.py, uci_gas.py). These parsers read the SAME on-disk formats the
published datasets ship in, behind an optional data directory — no
downloads happen here; point ``SPRINTZ_DATA_DIR`` (or ``data_dir=``) at
an existing checkout. A deterministic *miniature* corpus in the real
file formats (``make_mini_corpus``) is checked in under tests/data/ so
the parse -> quantize -> compress pipeline is exercised end-to-end
without the multi-GB downloads.

Formats (from the reference loaders, not copied code):
- UCR: per-dataset ``<Name>_TRAIN`` / ``<Name>_TEST`` text files; each
  row is ``label <sep> v1 <sep> v2 ...`` (comma or whitespace). For
  compression benchmarking, instances are concatenated with 5 linearly
  interpolated boundary samples (compress_bench.py:159-190,
  communicate/results.tex:17).
- MSRC-12: space-separated ``*.csv``: col 0 = timestamp, cols 1..80 =
  Kinect joint data; all-zero data rows are dropped (msrc.py:112-120).
- PAMAP2: space-separated ``*.dat``: col 0 timestamp, col 1 activity id,
  col 2 heart rate, then IMU columns; NaNs (missing samples) are
  forward-filled.
- AMPDs: comma-separated ``*.csv`` with a header row; col 0 = UNIX_TS,
  remaining columns are meter channels (ampds.py:26-34).
- UCI gas: tab-separated ``ethylene_*.txt``; first line is a header, 19
  columns: time, 2 concentrations, 16 sensors; data = cols 1:.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .corpus import quantize, write_dat

# ------------------------------------------------------------------ UCR


def parse_ucr_file(path: str | pathlib.Path, sep: str | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """One UCR split file -> (X (n_instances, length), labels)."""
    text = pathlib.Path(path).read_text()
    first = text.splitlines()[0]
    if sep is None:
        sep = "," if "," in first else None  # None -> any whitespace
    rows = [np.fromstring(line, dtype=np.float64, sep=sep or " ")
            for line in text.splitlines() if line.strip()]
    mat = np.vstack(rows)
    return mat[:, 1:], mat[:, 0]


def parse_ucr_dataset(dataset_dir: str | pathlib.Path
                      ) -> tuple[np.ndarray, np.ndarray]:
    """TRAIN + TEST concatenated (ucr.py:103-110)."""
    d = pathlib.Path(dataset_dir)
    name = d.name
    xs, ys = [], []
    for split in ("TRAIN", "TEST"):
        f = d / f"{name}_{split}"
        if not f.exists():
            cands = list(d.glob(f"*_{split}*"))
            if not cands:
                continue
            f = cands[0]
        x, y = parse_ucr_file(f)
        xs.append(x)
        ys.append(y)
    return np.vstack(xs), np.concatenate(ys)


def concat_and_interpolate(mats: list[np.ndarray], interp_npoints: int = 5
                           ) -> np.ndarray:
    """Join instance matrices with interp_npoints linearly interpolated
    boundary samples (compress_bench.py:159-190) so instance seams do not
    create artificial jumps."""
    if len(mats) == 1:
        return np.asarray(mats[0])
    out = [np.atleast_2d(np.asarray(m, np.float64)) if np.asarray(m).ndim == 1
           else np.asarray(m, np.float64) for m in mats]
    fracs = np.arange(1.0, interp_npoints + 1.0) / (interp_npoints + 1)
    pieces = [out[0]]
    for prev, nxt in zip(out[:-1], out[1:]):
        jump = nxt[0] - prev[-1]
        interp = prev[-1][None, :] + fracs[:, None] * jump[None, :]
        pieces.append(interp)
        pieces.append(nxt)
    return np.vstack(pieces)


def load_ucr(dataset_dir: str | pathlib.Path) -> np.ndarray:
    """UCR dataset -> one (rows, 1) float series in benchmark form."""
    X, _ = parse_ucr_dataset(dataset_dir)
    series = concat_and_interpolate([row[:, None] for row in X])
    return series


# ---------------------------------------------------------------- MSRC-12


def parse_msrc12(csv_path: str | pathlib.Path) -> np.ndarray:
    """(rows, 80) joint data; timestamp dropped, all-zero rows removed."""
    raw = np.loadtxt(csv_path)
    data = raw[:, 1:]
    keep = np.abs(data).sum(axis=1) != 0
    return data[keep]


def load_msrc12(data_dir: str | pathlib.Path) -> np.ndarray:
    files = sorted(pathlib.Path(data_dir).glob("*.csv"))
    return np.vstack([parse_msrc12(f) for f in files])


# ----------------------------------------------------------------- PAMAP


def parse_pamap(dat_path: str | pathlib.Path) -> np.ndarray:
    """All non-timestamp columns, NaNs forward-filled (missing samples,
    pamap2.py MISSING_DATA_VALUE)."""
    raw = np.loadtxt(dat_path)
    data = raw[:, 1:]
    # forward-fill NaNs per column; leading NaNs -> 0
    mask = np.isnan(data)
    idx = np.where(~mask, np.arange(data.shape[0])[:, None], 0)
    np.maximum.accumulate(idx, axis=0, out=idx)
    filled = data[idx, np.arange(data.shape[1])[None, :]]
    filled[np.isnan(filled)] = 0.0
    return filled


def load_pamap(data_dir: str | pathlib.Path) -> np.ndarray:
    files = sorted(pathlib.Path(data_dir).glob("*.dat"))
    return np.vstack([parse_pamap(f) for f in files])


# ----------------------------------------------------------------- AMPDs


def parse_ampds(csv_path: str | pathlib.Path) -> np.ndarray:
    """Meter channels (columns after UNIX_TS), header skipped."""
    raw = np.loadtxt(csv_path, delimiter=",", skiprows=1)
    return raw[:, 1:]


def load_ampds(data_dir: str | pathlib.Path) -> np.ndarray:
    files = sorted(pathlib.Path(data_dir).glob("*.csv"))
    mats = [parse_ampds(f) for f in files]
    width = min(m.shape[1] for m in mats)
    return np.vstack([m[:, :width] for m in mats])


# --------------------------------------------------------------- UCI gas


def parse_uci_gas(txt_path: str | pathlib.Path) -> np.ndarray:
    """(rows, 18): concentrations + 16 sensor channels (uci_gas.py:16-18,
    50-55)."""
    raw = np.loadtxt(txt_path, skiprows=1)
    return raw[:, 1:]


def load_uci_gas(data_dir: str | pathlib.Path) -> np.ndarray:
    files = sorted(pathlib.Path(data_dir).glob("ethylene_*.txt"))
    return np.vstack([parse_uci_gas(f) for f in files])


# ------------------------------------------------------------- dispatch


CORPUS_LOADERS = {
    "ucr": load_ucr,
    "msrc12": load_msrc12,
    "pamap": load_pamap,
    "ampds": load_ampds,
    "uci_gas": load_uci_gas,
}


def load_corpus(name: str, data_dir: str | pathlib.Path) -> np.ndarray:
    """Parse one corpus from its real file format -> float (rows, D)."""
    sub = pathlib.Path(data_dir) / name
    if name == "ucr":
        # each subdirectory is one UCR dataset; concatenate them
        dsets = sorted(p for p in sub.iterdir() if p.is_dir())
        return np.vstack([load_ucr(d) for d in dsets])
    return CORPUS_LOADERS[name](sub)


def corpus_to_benchmark(name: str, data_dir: str | pathlib.Path,
                        out_root: str | pathlib.Path) -> list[pathlib.Path]:
    """Parse, quantize, and emit the reference benchmark layout
    ({row,col}major/uint{8,16}/<name>.dat — README.md:43-46)."""
    mat = load_corpus(name, data_dir)
    out = []
    for dtype in (np.uint8, np.uint16):
        q = quantize(mat, dtype=dtype)
        for order in ("c", "f"):
            out.append(write_dat(out_root, name, q, order=order))
    return out


# --------------------------------------------------- miniature corpus


def make_mini_corpus(root: str | pathlib.Path, seed: int = 0) -> None:
    """Write a tiny corpus in each REAL file format (deterministic
    synthetic values) so parsers and ratio benchmarks run end-to-end
    offline. Checked in under tests/data/mini_corpus/."""
    rng = np.random.default_rng(seed)
    root = pathlib.Path(root)

    # UCR: two datasets, comma-separated, label + 64 values
    for dname in ("MiniRamp", "MiniWave"):
        d = root / "ucr" / dname
        d.mkdir(parents=True, exist_ok=True)
        for split, n in (("TRAIN", 12), ("TEST", 8)):
            t = np.arange(64)
            base = (np.sin(t / 7.0)[None, :] * rng.uniform(1, 4, (n, 1))
                    + rng.normal(0, 0.08, (n, 64)).cumsum(axis=1))
            lbl = rng.integers(1, 4, n)
            lines = [",".join([str(int(l))] + [f"{v:.5f}" for v in row])
                     for l, row in zip(lbl, base)]
            (d / f"{dname}_{split}").write_text("\n".join(lines) + "\n")

    # MSRC-12: space-separated, timestamp + 80 cols, some all-zero rows
    d = root / "msrc12"
    d.mkdir(parents=True, exist_ok=True)
    for i in range(2):
        n = 120
        ts = np.arange(n)[:, None] * 1000.0
        joints = rng.normal(0, 0.02, (n, 80)).cumsum(axis=0) + 0.7
        joints[::37] = 0.0  # dropped rows
        np.savetxt(d / f"P{i+1}_1_1_p{i+1}.csv",
                   np.hstack([ts, joints]), fmt="%.6f", delimiter=" ")

    # PAMAP2: space-separated, timestamp + activity + HR(+NaNs) + IMU
    d = root / "pamap"
    d.mkdir(parents=True, exist_ok=True)
    n = 150
    ts = np.arange(n)[:, None] * 0.01
    act = np.repeat(rng.integers(0, 5, n // 30), 30)[:n, None] * 1.0
    hr = np.full((n, 1), np.nan)
    hr[::9] = 80 + rng.normal(0, 3, (len(hr[::9]), 1))
    imu = rng.normal(0, 0.1, (n, 12)).cumsum(axis=0)
    np.savetxt(d / "subject101.dat",
               np.hstack([ts, act, hr, imu]), fmt="%.5f", delimiter=" ")

    # AMPDs: CSV with header, UNIX_TS + 3 meter cols, steppy values
    d = root / "ampds"
    d.mkdir(parents=True, exist_ok=True)
    n = 200
    ts = 1333263600 + np.arange(n) * 60
    counter = np.cumsum(rng.integers(0, 3, n))
    avg_rate = np.repeat(rng.integers(0, 30, n // 50), 50)[:n]
    inst = avg_rate + rng.integers(0, 3, n)
    lines = ["UNIX_TS,counter,avg_rate,inst_rate"] + [
        f"{a},{b},{c},{e}" for a, b, c, e in zip(ts, counter, avg_rate, inst)]
    (d / "Gas.csv").write_text("\n".join(lines) + "\n")

    # UCI gas: tab-separated, header line, time + 2 conc + 16 sensors
    d = root / "uci_gas"
    d.mkdir(parents=True, exist_ok=True)
    n = 180
    t = np.arange(n)[:, None] * 0.1
    conc = np.abs(rng.normal(0, 1, (n, 2)).cumsum(axis=0))
    sens = 500 + rng.normal(0, 5, (n, 16)).cumsum(axis=0)
    mat = np.hstack([t, conc, sens])
    body = "\n".join(" \t".join(f"{v:.4f}" for v in row) for row in mat)
    (d / "ethylene_CO.txt").write_text("Time (s) ...header...\n" + body + "\n")
