"""Dump one collated batch to a pickle (a test fixture tool).

Counterpart of `occdepth_tpu/scripts/dump_batch.py` (the reference
DataModule __main__ blocks that write `data.pkl`, kitti_dm.py:146-182,
nyu_dm.py:103-132): one batch of the config's disk dataset, or with
`--synthetic` a random, geometrically consistent one (`make_synthetic_batch`,
the same arrays as the JAX package's).  The pickle holds numpy arrays, so
either package can read it:

    python -m occdepth_tpu_torch.scripts.dump_batch --config CONFIG.yaml \\
        --out data.pkl [--synthetic] [--split val] [--batch-size 1] \\
        [key=value ...]
"""
from __future__ import annotations

import argparse
import pickle

from occdepth_tpu_torch.config import load_config, parse_overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))

    if args.synthetic:
        from occdepth_tpu_torch.data.batch import make_synthetic_batch

        # with the training targets, as the JAX package's default
        batch = make_synthetic_batch(cfg, batch_size=args.batch_size,
                                     with_labels=True)
    else:
        from occdepth_tpu_torch.data.kitti import Loader
        from occdepth_tpu_torch.training.trainer import make_datasets

        train_ds, val_ds = make_datasets(cfg)
        ds = train_ds if args.split == "train" else val_ds
        loader = Loader(ds, args.batch_size, shuffle=False, drop_last=False,
                        num_workers=0)
        batch = next(iter(loader))

    with open(args.out, "wb") as f:
        pickle.dump(batch, f)
    print("wrote", args.out, "keys:", sorted(batch.keys()))


if __name__ == "__main__":
    main()
