#!/usr/bin/env python3
"""Compress the trained CNN into a committable artifact.

The dense retrained weights are ~1 GB float32 (fc6 = 4096 x 57600 is 94%
of it) and gitignored, so every round had to retrain from scratch.  This
script factorizes fc6/fc7 with a truncated randomized SVD
(``models/factorize``), fine-tunes the factorized network for a few
thousand steps to recover the sigmoid-grid fit, and stores the result as
float16 npz — tens of MB, versionable.  ``cnn.forward`` consumes the
factorized layers natively (and fc6's matmul FLOPs drop ~15x).

Usage:
  python scripts/compress_weights.py                    # factorize + finetune
  python scripts/compress_weights.py --steps 0          # factorize only
  python scripts/compress_weights.py --rank6 512 --rank7 512
Evaluate afterwards:
  python benchmark.py --synthetic --run_cnn --update_datafiles \
      --weights assets/weights_compact.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default="assets/weights.npz")
    ap.add_argument("--out", default="assets/weights_compact.npz")
    ap.add_argument("--rank6", type=int, default=256)
    ap.add_argument("--rank7", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3000,
                    help="fine-tune steps (batch 32)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    import jax
    import jax.numpy as jnp

    from vanishing_points_2017_tpu import weights as wload
    from vanishing_points_2017_tpu.models import factorize, train

    print(f"loading {args.weights} ...")
    # host numpy: the randomized SVD is host-side, and a device-resident
    # fc6 would cost a ~1 GB device-to-host copy just to factorize it
    params = wload.params_from_npz(args.weights, as_numpy=True)
    ranks = {"fc6": args.rank6, "fc7": args.rank7}
    print(f"factorizing {ranks} ...")
    t0 = time.time()
    fac = factorize.factorize_params(params, ranks, seed=args.seed)
    print(f"  done in {time.time() - t0:.1f}s")
    fac = jax.tree.map(jnp.asarray, fac)

    mean = np.load("assets/mean.npy")
    mean_j = jnp.asarray(mean)

    if args.steps > 0:
        train.BASE_LR = args.lr
        rng_np = np.random.default_rng(args.seed)
        state = train.TrainState(
            params=fac, momentum=jax.tree.map(jnp.zeros_like, fac),
            step=jnp.zeros((), jnp.int32))
        rng = jax.random.PRNGKey(args.seed + 1)
        t0, running = time.time(), []
        for step in range(args.steps):
            imgs, labels = train.make_batch(rng_np, batch=args.batch,
                                            mean=mean_j)
            state, loss = train.train_step(state, imgs, labels,
                                           jax.random.fold_in(rng, step))
            running.append(float(loss))
            if (step + 1) % 200 == 0:
                rate = 200 * args.batch / (time.time() - t0)
                print(f"step {step + 1}  loss {np.mean(running):.4f}  "
                      f"{rate:.1f} img/s", flush=True)
                running, t0 = [], time.time()
        fac = state.params

    wload.params_to_npz(fac, args.out, dtype=np.float16)
    sz = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({sz:.1f} MB float16)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
