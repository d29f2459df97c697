"""JAX and the port side by side for a few AdamW steps at a wide width.

    PYTHONPATH=src python tests/wide_train_steps.py [--layers 2]
        [--d-model 2048] [--vocab 8192] [--seq 128] [--steps 6]
        [--dtype float32]

Not a test (pytest does not collect it): it runs on the CPU and, at the
default width, holds about 136 M parameters in each package, several
GiB in all.  stablelm-1.6b's structure (MHA, head_dim 64, partial
rotary, d_ff = 11/4 d_model) at ``--d-model`` and ``--layers``, the JAX
package's weights from ``PRNGKey(0)`` carried into the port, the
launcher's schedule for ``--steps`` steps (a one-step warm-up below 20
steps) and the same synthetic batches on both sides; it prints each
step's loss and grad norm from both packages.  At d_model 2,048 the
first full-lr step raises the loss in both, which is what the full-width
training run on the card shows.
"""
import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.data.pipeline import SyntheticLM
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.optim import adamw


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args()
    d = args.d_model
    over = dict(name=f"stablelm-wide-{d}", n_layers=args.layers, d_model=d,
                d_ff=d * 11 // 4, n_heads=d // 64, n_kv_heads=d // 64,
                head_dim=64, vocab_size_raw=args.vocab, dtype=args.dtype)
    jcfg = dataclasses.replace(jregistry.get_arch("stablelm-1.6b"), **over)
    cfg = dataclasses.replace(registry.get_arch("stablelm-1.6b"), **over)
    kw = dict(total_steps=max(args.steps, 2),
              warmup_steps=max(args.steps // 10, 1))
    jopt, opt = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.model_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), cfg, device="cpu")
    jst, st = jadamw.init(jp, jopt), adamw.init(params, opt)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, remat=False))
    step = steps.make_train_step(cfg, opt, remat=False)
    data = SyntheticLM(cfg.vocab_size_raw, args.seq, 2, seed=0)
    print(f"{cfg.name}: {args.layers} layers, vocab {args.vocab}, seq "
          f"{args.seq}, {args.dtype}, {JM.count_params(jcfg):,} params")
    for i in range(args.steps):
        b = data.batch_at(i)
        jp, jst, jm = jstep(jp, jst, {k: jax.numpy.asarray(v)
                                      for k, v in b.items()})
        params, st, m = step(params, st, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        print(f"step {i}: loss jax {float(jm['loss']):.6f} port "
              f"{float(m['loss']):.6f}; grad norm jax "
              f"{float(jm['grad_norm']):.4f} port "
              f"{float(m['grad_norm']):.4f}", flush=True)


if __name__ == "__main__":
    main()
