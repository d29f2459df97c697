"""Serving launcher with a policy-tiered paged KV cache, in torch.

The port of ``repro/launch/serve.py``: batched greedy decoding of any
attention architecture (dense, vlm, hybrid, MoE with GQA or MLA,
enc-dec; reduced by default,
``--full`` for the published widths and depth; SSM models are refused,
as the JAX launcher refuses them) while the KV pages of one attention
layer live in a two-tier paged cache placed by ANY registered placement
policy (``--policy``, every family of ``experiment.POLICY_REGISTRY``),
written, attended,
observed and migrated every token.  It reports throughput and the
robustness leaderboard's telemetry: modeled tiered-vs-all-fast wall
ratio, wasteful-migration fraction, promotions/demotions.

Telemetry accumulates on the device (the TieredPool) and is read once
after the decode loop; ``--sync-telemetry`` reads it every token instead.
``--capture PATH`` saves the per-token paged-KV attention-mass stream as
a replayable ``TraceWorkload`` (simulator/traces.py), grouped by the
pool's ``policy_every``.  Weights are random, drawn from a
``torch.Generator`` on the device seeded by ``--seed`` (or passed in as
``params``); the tiered layer's q/k/v telemetry streams come from one CPU
generator seeded by ``--seed``, so a card run and a CPU run see the same
streams.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --full --tokens 512 --batch 8 --policy memtis --capture /tmp/kv.npz
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llava-next-mistral-7b --full --tokens 128 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --full --tokens 128 --batch 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.tiering import paged_kv as PK
from repro_torch.tiering import tiered_pool as TP
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class ServeReport:
    """One serving run's throughput + leaderboard-style telemetry."""
    arch: str
    policy: str
    tok_s: float
    promotions: int
    demotions: int
    wasteful: int
    thrash: float            # wasteful / migrations (leaderboard metric)
    slowdown: float          # modeled tiered wall / all-fast wall
    fast_mass: np.ndarray    # [T] fast-tier attention-mass share per step
    telemetry: dict          # full tiered_pool.telemetry record
    trace: object = None     # TraceWorkload when capture=True
    kv: object = None        # final PagedKV (tests inspect the pools)
    init_s: float = 0.0      # wall seconds of weight + cache set-up


def draw_stream(gen: torch.Generator, batch: int, cfg, device):
    """``draw(t) -> (q, k_new, v_new)``: the tiered layer's per-token
    telemetry, f32 normal draws from ``gen`` (a CPU generator, drawn in
    token order) moved to ``device``.  K and V are distinct streams.  On
    the card the draws go through pinned memory, so the copy does not
    synchronise the stream."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pin = torch.device(device).type == "cuda"

    def draw(t: int):
        out = []
        for shape in ((batch, H, dh), (batch, KV, dh), (batch, KV, dh)):
            x = torch.randn(shape, generator=gen)
            out.append(x.pin_memory().to(device, non_blocking=True) if pin
                       else x)
        return tuple(out)

    return draw


def serve_token(params, cfg, pk_cfg, token, cache, kv, mass_ewma, t: int,
                draw):
    """One decode step of the serving loop: model ``decode_step``, greedy
    argmax, the tiered layer driven with this step's q/k/v (``draw(t)``),
    and the long-EWMA fast-mass share (the share of DECAYED attention mass
    resident fast).  Returns ``(token, cache, kv, plan, mass_ewma,
    share)``; the cache and the KV pools are updated in place."""
    logits, cache = M.decode_step(params, token, cache, t, cfg)
    token = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    q, k_new, v_new = draw(t)
    _, kv, plan = PK.serve_decode_step(kv, q, k_new, v_new, t, pk_cfg)
    mass_ewma = 0.98 * mass_ewma + plan.access
    share = (mass_ewma * kv.pool.in_fast).sum() \
        / torch.clamp_min(mass_ewma.sum(), 1e-9)
    return token, cache, kv, plan, mass_ewma, share


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(arch, n_tokens: int, batch: int, full: bool = False,
          page_size: int = 16, fast_frac: float = 0.25, seed: int = 0,
          policy: str = "arms", machine: str = TP.DEFAULT_MACHINE,
          device=None, params=None):
    """The serving loop's starting state on ``device`` (``None``: the
    CUDA card): ``(cfg, params, pk_cfg, kv, cache, draw)``.  ``arch`` is
    a registry name or a ``ModelConfig`` (a published config cut in
    depth, say).  ``params`` defaults to random weights from a generator
    on ``device`` seeded by ``seed``; ``draw`` is ``draw_stream`` over a
    CPU generator seeded by ``seed``."""
    device = resolve_device(device)
    cfg = arch if isinstance(arch, ModelConfig) else registry.get_arch(arch)
    if not full:
        cfg = registry.reduced(cfg)
    if cfg.family in ("ssm",):
        raise SystemExit(f"{arch}: attention-free arch — KV tiering "
                         "inapplicable (DESIGN.md §5); use plain decode.")
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
    n_pages = max(4, -(-n_tokens // page_size))
    pk_cfg = PK.PagedKVConfig(
        page_size=page_size, n_pages=n_pages,
        fast_pages=max(1, int(n_pages * fast_frac)), policy_every=4,
        machine=machine)
    # one tiered paged KV per attention layer is the production layout;
    # this launcher tiers layer 0 and decodes the stack with the model cache.
    kv = PK.init_paged_kv(pk_cfg, batch, cfg.n_kv_heads, cfg.head_dim,
                          dtype=torch.float32, policy=policy, device=device)
    cache = M.init_cache(cfg, batch, n_pages * page_size, device)
    draw = draw_stream(torch.Generator(device="cpu").manual_seed(seed),
                       batch, cfg, device)
    return cfg, params, pk_cfg, kv, cache, draw


def serve(arch, n_tokens: int, batch: int, full: bool = False,
          page_size: int = 16, fast_frac: float = 0.25, seed: int = 0,
          policy: str = "arms", machine: str = TP.DEFAULT_MACHINE,
          sync_telemetry: bool = False, capture: bool = False,
          quiet: bool = False, device=None, params=None) -> ServeReport:
    """Decode ``n_tokens`` greedy tokens for ``batch`` sequences on
    ``device`` (``None``: the CUDA card) with layer 0's KV cache tiered
    by ``policy``; ``arch`` and ``params`` as ``setup`` takes them.
    ``capture=True`` returns the access trace in ``ServeReport.trace``."""
    device = resolve_device(device)
    t_init = time.time()
    cfg, params, pk_cfg, kv, cache, draw = setup(
        arch, n_tokens, batch, full, page_size, fast_frac, seed, policy,
        machine, device, params)
    arch = arch if isinstance(arch, str) else cfg.name
    _sync(device)
    init_s = time.time() - t_init

    token = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    mass_ewma = torch.zeros((pk_cfg.n_pages,), dtype=torch.float32,
                            device=device)
    shares = []    # device scalars; one transfer after the loop
    masses = []    # device [n_pages] access rows (trace capture)
    promotions_sync = 0
    t0 = time.time()
    for t in range(n_tokens):
        token, cache, kv, plan, mass_ewma, share = serve_token(
            params, cfg, pk_cfg, token, cache, kv, mass_ewma, t, draw)
        shares.append(share)
        if capture:
            masses.append(plan.access)
        if sync_telemetry:
            promotions_sync += int(plan.count)
            float(plan.fast_share)
    _sync(device)
    dt = time.time() - t0
    tok_s = n_tokens * batch / dt

    tele = TP.telemetry(kv.pool)                   # the one host sync
    fast_mass = torch.stack(shares).cpu().numpy()
    trace = None
    if capture:
        from repro_torch.simulator import traces
        trace = traces.capture_from_steps(
            torch.stack(masses).cpu().numpy(), group=pk_cfg.policy_every,
            label=f"{arch}-kv")
    if sync_telemetry:
        assert promotions_sync == tele["promotions"]
    rep = ServeReport(
        arch=arch, policy=str(policy), tok_s=tok_s,
        promotions=tele["promotions"], demotions=tele["demotions"],
        wasteful=tele["wasteful"], thrash=tele["thrash"],
        slowdown=tele["slowdown"], fast_mass=fast_mass, telemetry=tele,
        trace=trace, kv=kv, init_s=init_s)
    if not quiet:
        print(f"[serve] {arch}/{rep.policy}: {n_tokens} steps x {batch} "
              f"seqs = {tok_s:,.0f} tok/s"
              + (" (sync telemetry)" if sync_telemetry else ""))
        print(f"[serve] tiering: {rep.promotions} promotions / "
              f"{rep.demotions} demotions, thrash={rep.thrash:.3f}, "
              f"modeled slowdown vs all-fast = {rep.slowdown:.2f}x, "
              f"fast-tier attention-mass share (end) = "
              f"{fast_mass[-1]:.2%}")
    return rep


def main():
    from repro_torch.simulator.experiment import POLICY_REGISTRY
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--policy", default="arms",
                    choices=sorted(POLICY_REGISTRY))
    ap.add_argument("--machine", default=TP.DEFAULT_MACHINE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-telemetry", action="store_true",
                    help="per-token host-sync telemetry (slow)")
    ap.add_argument("--capture", default=None, metavar="PATH",
                    help="save the paged-KV access trace as an .npz "
                         "TraceWorkload")
    args = ap.parse_args()
    rep = serve(args.arch, args.tokens, args.batch, full=args.full,
                policy=args.policy, machine=args.machine, seed=args.seed,
                sync_telemetry=args.sync_telemetry,
                capture=args.capture is not None)
    if args.capture:
        rep.trace.save(args.capture)
        print(f"[serve] trace [{rep.trace.T}x{rep.trace.n}] -> "
              f"{args.capture}")


if __name__ == "__main__":
    main()
