"""One client in a closed loop: its next call when the last returns, call
i taking input i mod the number of inputs, until ``seconds`` have passed;
the last call runs to its end and the window ends with it."""

from __future__ import annotations

import time
import traceback

from portbench.loop import Keeper, Window

KEYS = ()  # no keys besides every mix's


def run(call, args: list, seconds: float, params: dict, seed: int) -> Window:
    keeper = Keeper(params["keep"], seed)
    lat, used = [], []
    failed, first_error = 0, None
    n_args = len(args)
    start = time.perf_counter()
    i = 0
    while True:
        k = i % n_args
        t = time.perf_counter()
        try:
            out = call(args[k])
        except Exception:  # a failed call counts against the run
            out = None
            failed += 1
            if first_error is None:
                first_error = traceback.format_exc()
        t1 = time.perf_counter()
        lat.append(t1 - t)
        used.append(k)
        keeper.offer(i, out)
        i += 1
        if t1 - start >= seconds:
            return Window(start, t1, lat, used, keeper.kept, failed,
                          first_error)
