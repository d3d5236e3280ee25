"""Throughput of the host data pipeline at 512², the port's
``data/pipeline.CocoH5Dataset`` and ``data/prefetch.PrefetchingLoader``.

    python -m improved_body_parts_tpu_torch.tools.bench_pipeline \
        [--records 24] [--steps 6] [--batch 8] [--workers 1 2 4 6] [--compact]

Port of the repo's ``tools/bench_pipeline.py``. It writes a reference-layout
h5 (coco_masks_hdf5.py:270-314) of multi-person 480x640 records
(``write_crowd_h5``, kept at ``--h5`` and reused when it exists), then
times one ``__getitem__`` (the median of 8) and its stages (h5 read, the
augmentation warp, the heatmapper), and the loader's samples/s at each
``--workers`` count. The last line is one JSON object with the JAX tool's
keys (``single_sample_ms``, ``samples_per_s_w<N>``) and ``stage_ms``;
progress goes to stderr. Host only: it needs h5py and cv2 and no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# canonical template -> COCO-17 order (drop neck, reorder face/limbs):
# [nose, Leye, Reye, Lear, Rear, Lsho, Rsho, Lelb, Relb, Lwri, Rwri, Lhip,
#  Rhip, Lkne, Rkne, Lank, Rank]
CANON_TO_COCO17 = [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10]


def write_crowd_h5(path: str, n_records: int, img_hw=(480, 640),
                   people_per_img: int = 4, seed: int = 0) -> None:
    """Reference-layout h5 of ``n_records`` multi-person records (COCO-17
    joints), the JAX tool's records for the same seed."""
    import h5py

    from improved_body_parts_tpu_torch.data.synthetic import _TEMPLATE

    rng = np.random.RandomState(seed)
    H, W = img_hw
    with h5py.File(path, "w") as f:
        data_grp = f.create_group("dataset")
        img_grp = f.create_group("images")
        mask_grp = f.create_group("masks")
        for r in range(n_records):
            key = f"{r:012d}"
            img = rng.randint(0, 255, (H, W, 3), np.uint8)
            mask_miss = np.full((H, W), 255, np.uint8)
            mask_all = np.zeros((H, W), np.uint8)
            n_people = rng.randint(1, people_per_img + 1)
            joints, objpos, scales = [], [], []
            for _ in range(n_people):
                s = rng.uniform(0.35, 0.8) * H
                cx = rng.uniform(0.25, 0.75) * W
                cy = rng.uniform(0.25, 0.75) * H
                pts = (_TEMPLATE - [0.5, 0.5]) * s + [cx, cy]
                j17 = np.zeros((17, 3))
                for c17, canon in enumerate(CANON_TO_COCO17):
                    j17[c17, :2] = pts[canon]
                    j17[c17, 2] = 1.0
                joints.append(j17.tolist())
                objpos.append([float(cx), float(cy)])
                scales.append(float(s / 512.0))
                y0, y1 = int(max(cy - s / 2, 0)), int(min(cy + s / 2, H))
                x0, x1 = int(max(cx - s / 3, 0)), int(min(cx + s / 3, W))
                mask_all[y0:y1, x0:x1] = 255
            meta = {"image": key, "joints": joints,
                    "objpos": objpos, "scale_provided": scales}
            img_grp.create_dataset(key, data=img)
            mask_grp.create_dataset(
                key, data=np.stack([mask_miss, mask_all], axis=2))
            ds = data_grp.create_dataset(f"{r:07d}", data=json.dumps(meta))
            ds.attrs["meta"] = json.dumps(meta)


def stage_times(ds, idx: int, rng: np.random.RandomState) -> dict:
    """ms of each stage of ``ds.__getitem__(idx, rng)``: the h5 read, the
    augmentation warp (``Transformer.transform``) and the heatmapper."""
    from improved_body_parts_tpu_torch.configs import convert_coco_joints

    t0 = time.perf_counter()
    img, mask_miss, mask_all, meta = ds.read_raw(idx)
    t1 = time.perf_counter()
    joints = convert_coco_joints(np.asarray(meta["joints"]))
    img, mask_miss, mask_all, joints = ds.transformer.transform(
        img, mask_miss, mask_all, joints, tuple(meta["objpos"][0]),
        float(meta["scale_provided"][0]), aug=None, rng=rng)
    t2 = time.perf_counter()
    ds.heatmapper.create_heatmaps(joints, mask_all)
    t3 = time.perf_counter()
    return {"read": (t1 - t0) * 1e3, "warp": (t2 - t1) * 1e3,
            "heatmaps": (t3 - t2) * 1e3}


def run(h5: str, records: int = 24, steps: int = 6, batch: int = 8,
        workers=(1, 2, 4, 6), compact: bool = False, log=None) -> dict:
    """Write ``h5`` if it does not exist, then measure; the result dict."""
    from improved_body_parts_tpu_torch.configs import CanonicalConfig
    from improved_body_parts_tpu_torch.data.pipeline import CocoH5Dataset
    from improved_body_parts_tpu_torch.data.prefetch import PrefetchingLoader

    log = log or (lambda s: sys.stderr.write(s + "\n"))
    if not os.path.exists(h5):
        t0 = time.perf_counter()
        write_crowd_h5(h5, records)
        log(f"wrote {h5} in {time.perf_counter() - t0:.1f}s")

    ds = CocoH5Dataset(h5, CanonicalConfig(), augment=True)   # 512x512
    rng = np.random.RandomState(0)
    ds[0]                                                     # warm the h5
    lat, stages = [], []
    for i in range(8):
        t0 = time.perf_counter()
        r = np.random.RandomState(rng.randint(2 ** 31))
        if compact:
            ds.get_compact(i % len(ds), r)
        else:
            ds.__getitem__(i % len(ds), r)
        lat.append(time.perf_counter() - t0)
        stages.append(stage_times(ds, i % len(ds), np.random.RandomState(i)))
    lat_ms = float(np.median(lat) * 1e3)
    log(f"single-sample latency {lat_ms:.1f} ms "
        f"(-> {1e3 / lat_ms:.1f} samples/s/worker)")
    results = {"single_sample_ms": round(lat_ms, 1),
               "stage_ms": {k: round(float(np.median([s[k] for s in stages])), 2)
                            for k in stages[0]}}
    for w in workers:
        loader = PrefetchingLoader(ds, num_workers=w)
        it = loader.batches(batch, steps, seed=1, compact=compact)
        next(it)                                # the first batch's ramp-up
        t0 = time.perf_counter()
        n = 0
        for imgs, _, _ in it:
            n += len(imgs)
        dt = time.perf_counter() - t0
        results[f"samples_per_s_w{w}"] = round(n / dt, 1)
        log(f"workers={w}: {n} samples in {dt:.1f}s = {n / dt:.1f} samples/s")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=24)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 6])
    ap.add_argument("--h5", default=os.path.join(tempfile.gettempdir(),
                                                 "bench_pipeline_512.h5"))
    ap.add_argument("--compact", action="store_true",
                    help="compact samples for --feed compact: the host skips "
                         "GT rasterization (heatmaps render on the device, "
                         "data/heatmaps_device.py)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.h5, args.records, args.steps, args.batch,
                         args.workers, args.compact)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
