"""Bootstrap confidence intervals for the synthetic-AP harness (a copy of
the JAX package's ``tools/bootstrap_ap.py`` on the port's
``utils/oks_eval.KeypointEval``; host only, no card).

The held-out synthetic sets are small compared to the reference's ~5k-image
minival (reference evaluate.py:248-254), so a single AP number cannot
resolve deviations at the ~0.01 level an A/B asks about. This tool
re-scores an existing detections json (written by ``apps.evaluate``)
against its GT under B bootstrap resamples of the IMAGE set (sampled with
replacement, duplicates remapped to fresh image ids so the evaluator sees
them as independent scenes) and reports AP/AR with percentile intervals.

    python -m improved_body_parts_tpu_torch.tools.bootstrap_ap \
        --gt-json syn/gt.json --dets results/val2017_arm_results.json [--draws 500]

With two --dets files it also bootstraps the PAIRED ΔAP (the same image
resample applied to both arms: the statistic for an A/B on a shared image
set).
"""

import argparse
import json
import os
import sys

import numpy as np

from improved_body_parts_tpu_torch.utils.oks_eval import KeypointEval


def resample(gt, dets_list, rng):
    """One bootstrap draw: sample images with replacement, remap duplicates
    to fresh ids. Returns (gt', [dets', ...]) ready for KeypointEval."""
    ids = [im["id"] for im in gt["images"]]
    draw = rng.choice(ids, size=len(ids), replace=True)
    gt_by_img = {}
    for a in gt["annotations"]:
        gt_by_img.setdefault(a["image_id"], []).append(a)
    dt_by_img = [dict() for _ in dets_list]
    for k, dets in enumerate(dets_list):
        for d in dets:
            dt_by_img[k].setdefault(d["image_id"], []).append(d)

    images, anns = [], []
    new_dets = [[] for _ in dets_list]
    for new_id, old_id in enumerate(draw):
        images.append({"id": new_id})
        for a in gt_by_img.get(old_id, []):
            a = dict(a)
            a["image_id"] = new_id
            anns.append(a)
        for k in range(len(dets_list)):
            for d in dt_by_img[k].get(old_id, []):
                d = dict(d)
                d["image_id"] = new_id
                new_dets[k].append(d)
    return {"images": images, "annotations": anns}, new_dets


def score(gt, dets):
    return KeypointEval(gt, dets).run(print_fn=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--dets", required=True, nargs="+",
                    help="one detections json (CI for its AP) or two "
                         "(paired bootstrap of the ΔAP between them)")
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    with open(args.gt_json) as f:
        gt = json.load(f)
    dets_list = []
    for p in args.dets:
        with open(p) as f:
            dets_list.append(json.load(f))

    names = [os.path.basename(p) for p in args.dets]
    full = [score(gt, d) for d in dets_list]
    for name, stats in zip(names, full):
        print(f"{name}: AP={stats[0]:.4f} AP50={stats[1]:.4f} "
              f"AP75={stats[2]:.4f} APM={stats[3]:.4f} APL={stats[4]:.4f} "
              f"AR={stats[5]:.4f}")

    rng = np.random.RandomState(args.seed)
    aps = np.zeros((len(dets_list), args.draws))
    ars = np.zeros((len(dets_list), args.draws))
    for b in range(args.draws):
        gt_b, dets_b = resample(gt, dets_list, rng)
        for k, d in enumerate(dets_b):
            s = score(gt_b, d)
            aps[k, b], ars[k, b] = s[0], s[5]

    def ci(x):
        lo, hi = np.percentile(x, [2.5, 97.5])
        return f"[{lo:.4f}, {hi:.4f}] (std {x.std():.4f})"

    out = {"draws": args.draws}
    for k, name in enumerate(names):
        print(f"{name}: AP 95% CI {ci(aps[k])}  AR 95% CI {ci(ars[k])}")
        out[name] = {"ap": full[k][0], "ap_ci": list(np.percentile(aps[k], [2.5, 97.5])),
                     "ap_std": float(aps[k].std())}
    if len(dets_list) == 2:
        d = aps[0] - aps[1]
        print(f"paired ΔAP ({names[0]} - {names[1]}): "
              f"{full[0][0] - full[1][0]:+.4f}  95% CI {ci(d)}")
        out["delta_ap"] = {"point": full[0][0] - full[1][0],
                           "ci": list(np.percentile(d, [2.5, 97.5])),
                           "std": float(d.std())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
