"""Tuning studies: every baseline's knobs (paper §3) and ARMS's internal
knobs.

The port of ``repro/simulator/tuning.py`` (a JAX-free module of the JAX
package; the port keeps its own copy).  The paper tunes with SMAC; the
spaces here are small enough that a seeded search with a modest budget
finds the same best region.  ``tune_hemem``/``tune_memtis``/``tune_tpp``
return the best config per workload -- the paper's "Tuned-X" comparators
-- and ``tune_arms`` is the internal-knob sensitivity study (paper §6).

All of them are views over the search engine (``simulator/search.py``):
``strategy="grid"`` (exhaustive scoring, the default), ``"asha"``
(successive halving over a horizon ladder) or ``"ce"`` (cross-entropy
redraw).  Every round is one lane-batched pass of ``experiment.sweep``
with every lane sharing one common-random-number noise source, so the
rows rank the knobs alone.  Machines are taken by registry name.

Seeding is split: ``search_seed`` draws the config grid (and CE's
redraws), ``sim_seed`` the CRN noise the configs are scored under.
``device`` picks where the passes run (``None``: the CUDA card).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.baselines.arms_policy import ARMSSpec
from repro_torch.baselines.hemem import HeMemSpec
from repro_torch.baselines.hybridtier import HybridTierSpec
from repro_torch.baselines.jenga import JengaSpec
from repro_torch.baselines.memtis import MemtisSpec
from repro_torch.baselines.tierbpf import TierBPFSpec
from repro_torch.baselines.tpp import TPPSpec
from repro_torch.simulator import search

SPACE = dict(
    hot_threshold=[1, 2, 4, 8, 16, 32],
    cooling_threshold=[4, 9, 18, 36, 72],
    migration_period=[1, 2, 5, 10],
    sample_period=[2_500, 5_000, 10_000, 20_000],
)
HEMEM_DEFAULTS = dict(hot_threshold=8, cooling_threshold=18,
                      migration_period=5, sample_period=10_000)

MEMTIS_SPACE = dict(
    cooling_period_samples=[2.5e5, 5e5, 1e6, 2e6, 4e6],
    adaptation_period=[2, 5, 10, 20],
)
MEMTIS_DEFAULTS = dict(cooling_period_samples=2e6, adaptation_period=10)

TPP_SPACE = dict(
    promote_hits=[1, 2, 4, 8],
    watermark=[0.90, 0.95, 0.98, 0.995],
)
TPP_DEFAULTS = dict(promote_hits=2, watermark=0.98)

# ARMS internal knobs (paper §6 reports workloads are INSENSITIVE to these;
# the sweep reproduces that claim rather than hunting per-workload optima).
ARMS_SPACE = dict(
    alpha_s=[0.5, 0.6, 0.7, 0.8, 0.9],
    alpha_l=[0.05, 0.1, 0.2],
    noise_z=[0.0, 0.25, 0.5],
    pht_lambda=[0.05, 0.1, 0.2],
)
ARMS_DEFAULTS = dict(alpha_s=0.7, alpha_l=0.1, noise_z=0.25, pht_lambda=0.10)

# Tier-native families.  Their knobs take the same grid / asha / ce
# strategies: a population of one family is one pass a round.
HYBRIDTIER_SPACE = dict(
    hot_thresh=[2.0, 4.0, 6.0, 9.0, 12.0],
    warm_thresh=[0.5, 1.0, 2.0],
    decay=[0.5, 0.7, 0.9],
    migration_period=[2, 4, 8],
)
HYBRIDTIER_DEFAULTS = dict(hot_thresh=6.0, warm_thresh=1.0, decay=0.7,
                           migration_period=4)

JENGA_SPACE = dict(
    alpha=[0.3, 0.5, 0.7, 0.9],
    confirm=[1, 2, 3, 4],
    cooldown=[0, 1, 3, 6],
    migration_period=[1, 2],
)
JENGA_DEFAULTS = dict(alpha=0.5, confirm=2, cooldown=3, migration_period=1)

TIERBPF_SPACE = dict(
    alpha=[0.3, 0.5, 0.7],
    admit_thresh=[1.0, 2.0, 4.0, 8.0],
    thrash_gain=[0.5, 1.0, 2.0, 4.0],
    regret_alpha=[0.1, 0.3, 0.5],
)
TIERBPF_DEFAULTS = dict(alpha=0.5, admit_thresh=2.0, thrash_gain=2.0,
                        regret_alpha=0.3)

#: name -> (spec factory taking the space's keys as kwargs, space, defaults)
FAMILIES = {
    "hemem": (HeMemSpec.make, SPACE, HEMEM_DEFAULTS),
    "memtis": (MemtisSpec.make, MEMTIS_SPACE, MEMTIS_DEFAULTS),
    "tpp": (TPPSpec.make, TPP_SPACE, TPP_DEFAULTS),
    "arms": (lambda **cfg: ARMSSpec.make(cfg), ARMS_SPACE, ARMS_DEFAULTS),
    "hybridtier": (HybridTierSpec.make, HYBRIDTIER_SPACE,
                   HYBRIDTIER_DEFAULTS),
    "jenga": (JengaSpec.make, JENGA_SPACE, JENGA_DEFAULTS),
    "tierbpf": (TierBPFSpec.make, TIERBPF_SPACE, TIERBPF_DEFAULTS),
}


def _decode_grid_index(space: dict, keys: list, sizes: list, i: int) -> dict:
    """Mixed-radix decode of flat grid index ``i`` (last knob fastest —
    the ``itertools.product`` C order earlier revisions materialized)."""
    vals, rem = {}, int(i)
    for nm, size in zip(reversed(keys), reversed(sizes)):
        vals[nm] = space[nm][rem % size]
        rem //= size
    return {nm: vals[nm] for nm in keys}


def _sample_grid(space: dict, defaults: dict, budget: int, seed: int):
    """Seeded random draw from a knob grid (default config always tried).

    Grid indices are sampled and mixed-radix-decoded directly — the
    Cartesian product is never materialized, so the draw is O(budget)
    even for the larger spaces the search engine defines.  Returns at
    most ``budget`` configs: when the default config isn't among the
    draws, it REPLACES the last draw instead of growing the list (earlier
    revisions returned ``budget + 1`` configs).
    """
    rng = np.random.default_rng(seed)
    keys = list(space)
    sizes = [len(space[nm]) for nm in keys]
    total = math.prod(sizes)
    m = max(1, min(budget, total))
    if total > max(4096, 4 * m):
        # huge grid: rejection-sample unique indices, O(m) memory.
        picks, seen = [], set()
        while len(picks) < m:
            i = int(rng.integers(total))
            if i not in seen:
                seen.add(i)
                picks.append(i)
    else:
        # small grid: same draw stream as the historical rng.choice over
        # the materialized product, so seeded grids stay bit-identical.
        picks = [int(i) for i in rng.choice(total, size=m, replace=False)]
    configs = [_decode_grid_index(space, keys, sizes, i) for i in picks]
    defaults = dict(defaults)
    if defaults not in configs:
        if len(configs) >= budget:
            configs = configs[:max(0, budget - 1)]
        configs.insert(0, defaults)
    return configs


def sample_configs(budget: int, seed: int = 0):
    """HeMem knob draw (default config always tried)."""
    return _sample_grid(SPACE, HEMEM_DEFAULTS, budget, seed)


def sample_arms_configs(budget: int, seed: int = 0):
    """ARMS internal-knob draw (published defaults always tried)."""
    return _sample_grid(ARMS_SPACE, ARMS_DEFAULTS, budget, seed)


def _legacy(sr: search.SearchResult):
    return sr.best_config, sr.best_result, sr.rows


def tune(family: str, trace, machine, k, budget: int = 24,
         search_seed: int = 0, sim_seed: int = 0, space: dict | None = None,
         defaults: dict | None = None, workloads=None, T: int | None = None,
         n: int | None = None, *, strategy: str = "grid", machines=None,
         eta: int = 3, rounds: int | None = None, t_min: int = 16,
         ce_rounds: int = 4, elite_frac: float = 0.25,
         ce_smoothing: float = 0.7, base_cfg=None, mesh=None, device=None):
    """Lane-batched tuning of any policy family, under any strategy.

    -> (best_config, best_result, all (config, result) rows sorted by exec
    time).  ``search_seed`` draws the config grid (and CE's redraws);
    ``sim_seed`` seeds the shared CRN noise every lane is scored under.
    ``machine``: a registry name, MachineSpec or TieredMachineSpec.

    ``strategy`` picks the search loop (``simulator/search.py``):
    ``"grid"`` scores the whole budget in one full-horizon pass;
    ``"asha"`` (``eta``/``rounds``/``t_min``) eliminates over a geometric
    horizon ladder; ``"ce"`` (``ce_rounds``/``elite_frac``/
    ``ce_smoothing``) refits a sampling distribution each round.  Every
    round is one pass per family.  ``search.run`` gives the round
    records, pass counts and lane-intervals; this view keeps the
    ``(best_config, best_result, rows)`` shape.

    Workload-lane mode: ``workloads`` (names or ``WorkloadSpec``s, with
    ``T``/``n``; ``trace`` None) searches across W workloads, each round
    one pass of W x population lanes synthesized on the device, and
    returns ``{workload_name: (best_config, best_result, rows)}``.

    Machine-lane mode: ``machines=[...]`` (``machine`` is then ignored)
    tunes per machine, each round's union population x M machines in one
    pass, and returns ``{machine_name: (best_config, best_result,
    rows)}``; ``search.transfer_matrix`` builds on it.

    Every mode streams its per-interval outputs (rows carry scalar
    summaries), so tuning memory is O(lanes) whatever T.  ``mesh``:
    shards each pass over devices (``experiment.sweep``).  ``device``:
    ``None`` is the CUDA card.
    """
    out = search.run(family, strategy, trace=trace, machine=machine,
                     machines=machines, workloads=workloads, k=k,
                     budget=budget, eta=eta, rounds=rounds, t_min=t_min,
                     ce_rounds=ce_rounds, elite_frac=elite_frac,
                     ce_smoothing=ce_smoothing, search_seed=search_seed,
                     sim_seed=sim_seed, space=space, defaults=defaults,
                     base_cfg=base_cfg, T=T, n=n, mesh=mesh, device=device)
    if isinstance(out, dict):
        return {nm: _legacy(sr) for nm, sr in out.items()}
    return _legacy(out)


def tune_hemem(trace, machine, k, budget: int = 24, search_seed: int = 0,
               sim_seed: int = 0, strategy: str = "grid", **kw):
    """The paper's "Tuned-HeMem" comparator."""
    return tune("hemem", trace, machine, k, budget, search_seed, sim_seed,
                strategy=strategy, **kw)


def tune_memtis(trace, machine, k, budget: int = 24, search_seed: int = 0,
                sim_seed: int = 0, strategy: str = "grid", **kw):
    return tune("memtis", trace, machine, k, budget, search_seed, sim_seed,
                strategy=strategy, **kw)


def tune_tpp(trace, machine, k, budget: int = 24, search_seed: int = 0,
             sim_seed: int = 0, strategy: str = "grid", **kw):
    return tune("tpp", trace, machine, k, budget, search_seed, sim_seed,
                strategy=strategy, **kw)


def tune_arms(trace, machine, k, budget: int = 24, search_seed: int = 0,
              sim_seed: int = 0, base_cfg=None, strategy: str = "grid",
              **kw):
    """ARMS internal-knob search, one pass a round.  Trace-mode
    single-machine searches keep ARMS's ``"pre"`` sweep (per-mode
    observation grids computed once) instead of the per-interval CRN
    transform."""
    return tune("arms", trace, machine, k, budget, search_seed, sim_seed,
                base_cfg=base_cfg, strategy=strategy, **kw)
