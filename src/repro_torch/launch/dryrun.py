"""Multi-pod dry run: the port of ``repro/launch/dryrun.py``.

For every assigned (architecture x input shape) cell, run the step
function of the cell once on the production mesh, 16x16 (single pod) or
2x16x16 (multi pod), and record the per-device memory, cost and
collective bytes and their roofline terms as JSON.

It runs on the host, as JAX's does on 512 forced host devices: a
``fake`` process group of 256 or 512 ranks (this process is rank 0), a
``DeviceMesh`` from ``make_production_mesh``, params and optimizer state
from ``specs`` (``meta`` tensors: shapes, no storage) distributed as
DTensors by ``param_shardings``, and the step from ``steps``, run under
``roofline.StepCounter``.  ``meta`` tensors route attention and the SSD
scan to the hand-written kernels' custom ops, as CUDA tensors would, so
those count by the kernels' formulas, not as the plain version's full
``S x S`` scores.  (A fake CUDA tensor cannot be indexed on a host
without CUDA: the indexing path takes a CUDA device guard.)  Where JAX
compiles, the port traces: ``compile_s`` is the seconds the step took to
run on the shapes.  Rank 0's shard is the largest where a dim does not
split evenly.  Every number is modeled from published H100 SXM
constants (``roofline.py``), not measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch import roofline
from repro_torch.configs import registry
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, specs, steps
from repro_torch.optim import adamw
from repro_torch.utils.pytree import leaves

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

# grad-accumulation per train cell: keeps per-microbatch tokens/device ~4k.
GRAD_ACCUM = 8


def _local_bytes(tree) -> int:
    """Bytes of this device's shards of a tree's tensors."""
    return sum(t.to_local().numel() * t.element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in leaves(tree) if hasattr(t, "numel"))


def _run_step(cfg, shape, mesh):
    """Distribute the cell's inputs and run its step under a
    ``StepCounter`` -> (counter, argument bytes, output bytes)."""
    params_sds = specs.param_specs(cfg)
    if shape.kind == "decode":
        token, cache, _pos = specs.decode_specs(cfg, shape)
        params = sharding.distribute_tree(
            params_sds, sharding.param_shardings(params_sds, mesh,
                                                 serve=True), mesh)
        token = sharding.distribute_tree(
            token, sharding.batch_sharding(mesh, token), mesh)
        cache = sharding.distribute_tree(
            cache, sharding.cache_sharding(mesh, cache), mesh)
        args = (params, token, cache)
        step = steps.make_serve_step(cfg)
        # the last position: a decode step's cost does not depend on it
        # (every slot of the cache is read, masked)
        run = lambda: step(params, token, cache, shape.seq_len - 1)
    else:
        params = sharding.distribute_tree(
            params_sds, sharding.param_shardings(params_sds, mesh), mesh)
        batch_sds = specs.batch_specs(cfg, shape,
                                      with_labels=shape.kind == "train")
        batch = sharding.distribute_tree(
            batch_sds, sharding.batch_sharding(mesh, batch_sds), mesh)
        if shape.kind == "train":
            opt_cfg = adamw.AdamWConfig()
            opt_sds = specs.opt_specs(cfg, opt_cfg, params_sds)
            opt = sharding.distribute_tree(
                opt_sds, sharding.param_shardings(opt_sds, mesh), mesh)
            args = (params, opt, batch)
            step = steps.make_train_step(cfg, opt_cfg,
                                         grad_accum=GRAD_ACCUM, remat=True,
                                         mesh=mesh)
            run = lambda: step(params, opt, batch)
        else:
            args = (params, batch)
            step = steps.make_prefill_step(cfg, mesh=mesh)
            run = lambda: step(params, batch)
    arg_bytes = _local_bytes(args)
    with roofline.StepCounter() as counter:
        out = run()
    return counter, arg_bytes, _local_bytes(out)


def measure(cfg, shape, mesh, chips: int) -> dict:
    """Run one cell's step on ``mesh`` (a process group of ``chips``
    ranks is up) -> the record's measured part."""
    t0 = time.time()
    counter, arg_bytes, out_bytes = _run_step(cfg, shape, mesh)
    elapsed = time.time() - t0
    # per-device counts -> globals = per-device * chips
    analysis = counter.result()
    coll = {k: int(v) for k, v in analysis["collectives"].items()}
    terms = roofline.roofline(
        {"flops": analysis["flops"] * chips,
         "bytes accessed": analysis["bytes"] * chips},
        coll["_total"] * chips, chips)
    mflops = roofline.model_flops(cfg, shape)
    return {
        "status": "ok",
        "compile_s": round(elapsed, 1),
        "chips": chips,
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": counter.peak_bytes,
            "generated_code_size_in_bytes": 0},
        "cost_analysis": {"flops": analysis["flops"],
                          "bytes accessed": analysis["bytes"]},
        "collectives": coll,
        "roofline": terms.row(),
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / terms.flops) if terms.flops else None,
        "params": float(sum(t.numel() for t in
                            leaves(specs.param_specs(cfg)))),
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               dtype: str = "float32", force: bool = False) -> dict:
    """Run one cell on its production mesh; returns the result record.

    As JAX's, the artifacts take a uniform f32 model dtype (the JAX
    package's reason: its CPU lowering of bf16 products adds conversions
    a TPU program does not have).  The port's counts are of the eager
    ops, which have no such conversions, so the rule is kept only so
    that the two packages' records describe the same program."""
    cfg = registry.get_arch(arch)
    if dtype and cfg.dtype != dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    shape = registry.get_shape(shape_name)
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = shape_applicable(cfg, shape)
    if not ok and not force:
        return {**rec, "status": "skipped", "reason": why}
    chips = 512 if multi_pod else 256
    mesh_lib.bring_up("fake", world_size=chips)
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        return {**rec, **measure(cfg, shape, mesh, chips)}
    finally:
        mesh_lib.tear_down()


def run_cells(cells, meshes, out_dir: Path, skip_existing: bool = False,
              force: bool = False) -> list:
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for arch, shape_name in cells:
        for mesh_name in meshes:
            multi = mesh_name == "pod2"
            tag = f"{arch}__{shape_name}__{mesh_name}"
            path = out_dir / f"{tag}.json"
            if skip_existing and path.exists():
                rec = json.loads(path.read_text())
                if rec.get("status") in ("ok", "skipped"):
                    results.append(rec)
                    print(f"[dryrun] {tag}: cached {rec['status']}",
                          flush=True)
                    continue
            try:
                rec = lower_cell(arch, shape_name, multi, force=force)
            except Exception as e:   # a failure here is a sharding bug
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": mesh_name, "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            path.write_text(json.dumps(rec, indent=2))
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" compile={rec['compile_s']}s"
                         f" dom={r['dominant']}"
                         f" comp={r['compute_s']:.3e}s"
                         f" mem={r['memory_s']:.3e}s"
                         f" coll={r['collective_s']:.3e}s")
            print(f"[dryrun] {tag}: {status}{extra}", flush=True)
            results.append(rec)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="run a cell the assignment rules would skip "
                         "(extra, non-assigned artifacts)")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args()

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a.name, s.name) for a, s, _ok, _why in registry.all_cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    results = run_cells(cells, meshes, Path(args.out),
                        skip_existing=args.skip_existing, force=args.force)
    failed = [r for r in results if r["status"] == "FAILED"]
    print(f"[dryrun] done: {len(results)} cells, {len(failed)} failed")
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
