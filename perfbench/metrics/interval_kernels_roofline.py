"""Share of their roofline the four interval-step functions reach:
the least time of every call in the traced window (``work.py``: its bytes
over 3.35 TB/s or its operations over 67 TFLOP/s, whichever is larger),
summed, over the device time of their kernels (``ewma_update_kernel``,
``topk_mask_kernel``, ``tier_migrate_kernel``,
``tier_migrate_wide_kernel``, ``interval_account_kernel``).  The calls'
shapes are recorded by wrapping the program's kernel functions
(``repro_torch.kernels.interval_step.kernel``) for the window."""
import contextlib
import functools

from perfbench import devtrace, work


@contextlib.contextmanager
def instrument(rec):
    from repro_torch.kernels.interval_step import kernel
    least = rec.extra.setdefault("interval_least_s", [0.0])
    saved = {}

    def wrap(name, fn, count):
        @functools.wraps(fn)
        def timed(*args):
            least[0] += work.least_s(*count(*args))
            return fn(*args)
        return timed

    for name, (count, _) in work.FUNCTIONS.items():
        saved[name] = getattr(kernel, name)
        setattr(kernel, name, wrap(name, saved[name], count))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernel, name, fn)


def read(rec):
    least = rec.extra.get("interval_least_s", [0.0])[0]
    if not rec.events or least <= 0:
        return None
    names = {k for _, ks in work.FUNCTIONS.values() for k in ks}
    ns = sum(e - s for nm, s, e in rec.events
             if devtrace.kernel_base(nm) in names)
    if ns <= 0:
        return None
    return 100.0 * least / (ns / 1e9)
