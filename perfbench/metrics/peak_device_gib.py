"""Peak device memory of the traced window, GiB:
``torch.cuda.max_memory_allocated`` after a reset at the window's start."""
import contextlib

import torch


@contextlib.contextmanager
def instrument(rec):
    if torch.device(rec.cell.device).type != "cuda":
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    rec.extra["window_peak_bytes"] = torch.cuda.max_memory_allocated()


def read(rec):
    if "window_peak_bytes" not in rec.extra:
        return None
    return rec.extra["window_peak_bytes"] / 2 ** 30
