"""DataFrame storage backends (dfset.py:424-624 capability).

The port's copy of ``sprintz_tpu/frames/storage.py``: uniform
save/load/size over csv, npy (per-column), parquet and feather, plus a
"smart" backend that picks the smallest. H5 is included when pytables is
importable. pandas (and pyarrow, pytables) are imported only when a
backend runs, so ``sprintz_tpu_torch.frames`` imports without them.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _df():
    import pandas as pd

    return pd


class _Backend:
    ext = ""

    def save(self, df, path: pathlib.Path):
        raise NotImplementedError

    def load(self, path: pathlib.Path):
        raise NotImplementedError

    def size(self, path: pathlib.Path) -> int:
        p = pathlib.Path(path)
        if p.is_dir():
            return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())
        return p.stat().st_size


class CsvBackend(_Backend):
    ext = ".csv"

    def save(self, df, path):
        df.to_csv(path, index=False)

    def load(self, path):
        return _df().read_csv(path)


class NpyBackend(_Backend):
    """One .npy per column in a directory (preserves dtypes exactly)."""

    ext = ".npydir"

    def save(self, df, path):
        d = pathlib.Path(path)
        d.mkdir(parents=True, exist_ok=True)
        order = []
        for c in df.columns:
            np.save(d / f"{c}.npy", df[c].to_numpy())
            order.append(str(c))
        (d / "_columns.txt").write_text("\n".join(order))

    def load(self, path):
        d = pathlib.Path(path)
        cols = (d / "_columns.txt").read_text().splitlines()
        return _df().DataFrame(
            {c: np.load(d / f"{c}.npy") for c in cols})


class ParquetBackend(_Backend):
    ext = ".parquet"

    def save(self, df, path):
        df.to_parquet(path, index=False)

    def load(self, path):
        return _df().read_parquet(path)


class FeatherBackend(_Backend):
    ext = ".feather"

    def save(self, df, path):
        df.reset_index(drop=True).to_feather(path)

    def load(self, path):
        return _df().read_feather(path)


def available_backends() -> dict[str, _Backend]:
    out = {"csv": CsvBackend(), "npy": NpyBackend()}
    try:
        import pyarrow  # noqa: F401

        out["parquet"] = ParquetBackend()
        out["feather"] = FeatherBackend()
    except ImportError:
        pass
    try:
        import tables  # noqa: F401

        class H5Backend(_Backend):
            ext = ".h5"

            def save(self, df, path):
                df.to_hdf(path, key="df", mode="w")

            def load(self, path):
                return _df().read_hdf(path, key="df")

        out["h5"] = H5Backend()
    except ImportError:
        pass
    return out


def save_df(df, path: str | pathlib.Path, fmt: str = "smart") -> pathlib.Path:
    """Save with the named backend; fmt="smart" tries all and keeps the
    smallest (dfset.py SmartDfSet analogue). Returns the written path."""
    backends = available_backends()
    path = pathlib.Path(path)
    if fmt != "smart":
        b = backends[fmt]
        p = path.with_suffix(b.ext)
        b.save(df, p)
        return p
    best, best_size = None, float("inf")
    for name, b in backends.items():
        p = path.with_suffix(b.ext)
        try:
            b.save(df, p)
        except Exception:
            continue
        sz = b.size(p)
        if sz < best_size:
            if best is not None:
                _rm(best)
            best, best_size = p, sz
        else:
            _rm(p)
    assert best is not None, "no backend could save the frame"
    return best


def load_df(path: str | pathlib.Path):
    path = pathlib.Path(path)
    for b in available_backends().values():
        if path.suffix == b.ext or (path.is_dir() and b.ext == ".npydir"):
            return b.load(path)
    raise ValueError(f"no backend for {path}")


def _rm(p: pathlib.Path):
    if p.is_dir():
        for f in p.rglob("*"):
            f.unlink()
        p.rmdir()
    else:
        p.unlink(missing_ok=True)
