"""Set-up seconds on the host's clock: from the process's start to the
first timed pass (imports, the CUDA context, loading the kernels, inputs
from the seed and the warm-up pass)."""


def read(rec):
    return rec.setup_s
