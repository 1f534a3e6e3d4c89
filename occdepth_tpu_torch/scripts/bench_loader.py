"""Host data-pipeline throughput: KITTI `Loader` ms/sample on this host.

Counterpart of `occdepth_tpu/scripts/bench_loader.py`.  The reference's
per-sample host work is its known practical bottleneck (numba `vox2pix`
and python `compute_CP_mega_matrix` re-run for every sample,
kitti_dataset.py:258-301); here projections are cached per (sequence,
flip) and the CP matrix is vectorized.  This bench measures the full
`__getitem__` + collate at batch 1 over a synthetic full-size tree
(`testing.make_kitti_tree`: 370x1220 stereo PNGs, 256x256x32 labels) of
a config's data (the flagship by default), after one warm pass over the
split, with `--workers` loader threads (a comma-separated list times
each on the same warm dataset).

`--frustum native|plain` (or `native,plain`) times the per-frustum
class histograms' C++ pass or its NumPy loop
(`geometry/frustums_mask.py`): a switch of this bench only; the data
path always takes the native pass.  `--step-ms` (a train step's ms
measured on the card) adds the loader-to-step ratio: below 1 the loader
keeps pace with the step at batch 1.

    python -m occdepth_tpu_torch.scripts.bench_loader [--tree BASE] \\
        [--n 24] [--workers 0,2] [--frustum native,plain] [--step-ms MS]

Without `--tree` a 2-frame tree is built in a temporary directory and
removed after.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

FLAGSHIP = "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls"


def main(argv=None) -> list:
    """One result dict per (frustum, workers) case, in that order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="a make_kitti_tree base (a temporary 2-frame tree "
                         "by default)")
    ap.add_argument("--config", default=None,
                    help="config YAML (the port's flagship by default)")
    ap.add_argument("--n", type=int, default=24,
                    help="samples to time per case (after the warm pass)")
    ap.add_argument("--workers", default="2",
                    help="loader threads; comma-separated to time several")
    ap.add_argument("--frustum", default="native",
                    help="native, plain, or both comma-separated")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a train step's ms measured on the card")
    args = ap.parse_args(argv)
    workers = [int(w) for w in args.workers.split(",")]
    modes = args.frustum.split(",")
    if not set(modes) <= {"native", "plain"}:
        ap.error(f"--frustum: native or plain, not {args.frustum!r}")

    from occdepth_tpu_torch.config import default_config_path, load_config
    from occdepth_tpu_torch.data import kitti
    from occdepth_tpu_torch.geometry import frustums_mask

    tree = args.tree
    if tree is None:
        from occdepth_tpu_torch.testing import make_kitti_tree

        tree = tempfile.mkdtemp(prefix="bench_loader_")
        make_kitti_tree(tree, n_frames=2)
    cfg = load_config(args.config or default_config_path(FLAGSHIP), {
        "data_root": os.path.join(tree, "kitti"),
        "data_preprocess_root": os.path.join(tree, "pre"),
        "data_stereo_depth_root": os.path.join(tree, "stereo_depth"),
    })
    paths = {"native": kitti.compute_frustum_class_dists,
             "plain": frustums_mask.compute_frustum_class_dists_plain}
    results = []
    try:
        ds = kitti.KittiDataset(cfg, "train")
        # warm pass: fills the per-sequence vox2pix caches (on real KITTI
        # 10 sequences serve 3,834 samples, so the cold cost amortizes to
        # noise; the synthetic tree has 2 samples a sequence)
        t0 = time.perf_counter()
        ds[0]
        first_ms = (time.perf_counter() - t0) * 1e3
        for i in range(1, len(ds)):
            ds[i]
        print(f"dataset: {len(ds)} samples; first sample (cold vox2pix "
              f"cache): {first_ms:.1f} ms")
        for mode in modes:
            kitti.compute_frustum_class_dists = paths[mode]
            for w in workers:
                loader = kitti.Loader(ds, batch_size=1, shuffle=True,
                                      num_workers=w)
                done = 0
                t0 = time.perf_counter()
                while done < args.n:
                    for _ in loader:
                        done += 1
                        if done >= args.n:
                            break
                dt = time.perf_counter() - t0
                res = {"frustum": mode, "workers": w, "samples": done,
                       "dataset": len(ds), "first_sample_ms": first_ms,
                       "ms_per_sample": dt / done * 1e3,
                       "samples_per_s": done / dt}
                print(f"steady state: {res['samples_per_s']:.3f} samples/s "
                      f"({res['ms_per_sample']:.2f} ms/sample, workers={w}, "
                      f"frustum={mode})")
                if args.step_ms:
                    res["step_ms"] = args.step_ms
                    res["loader_per_step"] = (res["ms_per_sample"]
                                              / args.step_ms)
                    print(f"loader/step: {res['loader_per_step']:.3f} at "
                          f"batch 1 (step {args.step_ms:.2f} ms; below 1 "
                          "the loader keeps pace)")
                results.append(res)
    finally:
        kitti.compute_frustum_class_dists = paths["native"]
        if args.tree is None:
            shutil.rmtree(tree, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
