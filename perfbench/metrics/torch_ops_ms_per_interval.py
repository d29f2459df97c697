"""Device milliseconds an interval of PyTorch's own kernels: synthesis,
sampling, the policies and the replay's bookkeeping together.  Every
kernel of the traced window whose function is not one of
``PORT_KERNELS``; copies and sets left out.

``PORT_KERNELS`` is the program's hand-written CUDA kernels (every
``__global__`` function under ``src/repro_torch/kernels/*/csrc``) as they
stood when this benchmark was written, frozen here so that the yardstick
does not move with the program.  A kernel the program adds later counts
here among PyTorch's own; ``device_ms_per_interval`` keeps all device
time in view whatever runs it."""
from perfbench import devtrace

PORT_KERNELS = frozenset({
    # interval_step.cu
    "ewma_update_kernel", "interval_account_kernel", "tier_migrate_kernel",
    "tier_migrate_wide_kernel", "topk_mask_kernel",
    # migrate.cu
    "migrate_fire_kernel",
    # paged_attention.cu
    "pa_decode", "pa_mass",
    # flash_attention.cu
    "fa_fwd", "fa_delta", "fa_bwd_dkdv", "fa_bwd_dq", "fa_fwd_tc",
    "fa_bwd_dkdv_tc", "fa_bwd_dq_tc",
    # mamba_scan.cu
    "ms_cb", "ms_states", "ms_scan", "ms_out", "ms_bwd_chunk",
    "ms_reduce_bc", "ms_reduce_a",
})


def read(rec):
    if not rec.events or not rec.intervals:
        return None
    ns = sum(e - s for nm, s, e in rec.events
             if devtrace.is_kernel(nm)
             and devtrace.kernel_base(nm) not in PORT_KERNELS)
    return ns / 1e6 / rec.intervals
