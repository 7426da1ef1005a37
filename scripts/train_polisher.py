"""Train the medaka-equivalent NN polisher on realistic indel-rich pileups
(through the production mapper) and persist the weights shipped with the
package (`models/polisher_weights.npz`) — the analogue of medaka's
downloadable pretrained models.

Usage: python scripts/train_polisher.py [--steps 800]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--pairs", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    from hairsplitter_jax.models import polisher as P

    t0 = time.time()
    nn = P.train_polisher(
        seed=args.seed, steps=args.steps, realistic=True, n_pairs=args.pairs
    )
    path = args.out or P.WEIGHTS_PATH
    P.save_weights(nn, path)
    print(f"trained {args.steps} steps on {args.pairs} realistic pairs in "
          f"{time.time()-t0:.0f}s -> {path}")

    # quick self-check: per-column accuracy vs plain majority on held-out
    # realistic pairs
    import numpy as np

    rng = np.random.default_rng(1234)
    n_nn = n_maj = n_tot = 0
    for _ in range(6):
        feats, labels, w = P._realistic_training_pair(rng, L=2048)
        mask = w > 0
        maj = feats[:, :5].argmax(axis=1)
        pred = nn.logits(feats).argmax(axis=1)
        n_nn += int((pred[mask] == labels[mask]).sum())
        n_maj += int((maj[mask] == labels[mask]).sum())
        n_tot += int(mask.sum())
    print(f"held-out column accuracy: nn {n_nn/n_tot:.5f} vs majority {n_maj/n_tot:.5f}")


if __name__ == "__main__":
    main()
