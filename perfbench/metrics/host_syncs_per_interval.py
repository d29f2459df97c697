"""Host syncs an interval (replay loop): the operations that wait for
the device, counted by PyTorch's sync debug mode over the traced window,
over the intervals of its passes."""
import contextlib
import warnings

import torch


@contextlib.contextmanager
def instrument(rec):
    if torch.device(rec.cell.device).type != "cuda":
        yield
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rec.extra["syncs"] = sum("synchronizing CUDA operation" in str(w.message)
                             for w in caught)


def read(rec):
    if "syncs" not in rec.extra or not rec.intervals:
        return None
    return rec.extra["syncs"] / rec.intervals
