"""Self-contained COCO keypoint evaluation (OKS matching + 101-point AP).

A dependency-free implementation of the COCO keypoint metric so the
train -> evaluate -> AP loop closes in environments without pycocotools
(the reference hard-requires it, evaluate.py:274-280). The semantics follow
the published COCOeval keypoint protocol exactly:

  * OKS per (dt, gt) pair with the 17 per-keypoint sigmas, normalized by
    the gt area; unlabeled gts fall back to a distance-to-expanded-bbox
    penalty,
  * per-image greedy matching in detection-score order against each of the
    10 IoU thresholds 0.50:0.05:0.95, crowd/unlabeled gts as ignore
    regions, per-area-range gt/dt gating (all / medium / large),
  * score-sorted accumulation into 101-point interpolated
    precision/recall, maxDets=20,
  * the standard 10-number summary (AP, AP50, AP75, APM, APL, AR, ...).

The port's copy of ``improved_body_parts_tpu/utils/oks_eval.py`` (its
``KeypointEval``); ``apps/evaluate.py`` scores ``--gt-json`` with it, and
``tests/test_torch_shared.py`` holds it equal to the original.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# per-keypoint falloff constants, COCO order (nose, eyes, ears, shoulders,
# elbows, wrists, hips, knees, ankles) — the published COCO values
COCO_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72,
    .62, .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 20


def keypoints_bbox_area(kps: np.ndarray) -> tuple:
    """Detection bbox/area from the keypoint extent — what COCO.loadRes
    assigns to keypoint result entries (all keypoints, regardless of v)."""
    x, y = kps[0::3], kps[1::3]
    x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    return [float(x0), float(y0), float(x1 - x0), float(y1 - y0)], \
        float((x1 - x0) * (y1 - y0))


def compute_oks(dt_kps: np.ndarray, gt: Dict, sigmas: np.ndarray) -> float:
    """OKS of one detection (51,) against one gt annotation dict."""
    var = (sigmas * 2.0) ** 2
    g = np.asarray(gt["keypoints"], np.float64)
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    d = np.asarray(dt_kps, np.float64)
    xd, yd = d[0::3], d[1::3]
    k1 = int(np.count_nonzero(vg > 0))
    if k1 > 0:
        dx, dy = xd - xg, yd - yg
    else:
        # unlabeled gt: distance to the bbox expanded by 1x on every side
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        z = np.zeros_like(xd)
        dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
        dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
    e = (dx ** 2 + dy ** 2) / var / (gt["area"] + np.spacing(1)) / 2.0
    if k1 > 0:
        e = e[vg > 0]
    return float(np.sum(np.exp(-e)) / e.shape[0])


class KeypointEval:
    """COCO keypoint AP/AR over COCO-format gt + detection dicts.

    gt: {"images": [{"id": ...}, ...], "annotations": [...]} — annotations
        need image_id, keypoints (51,), num_keypoints, area, bbox, iscrowd.
        Missing num_keypoints/area/bbox are derived from the keypoints.
    dt: [{"image_id", "keypoints" (51,), "score"}, ...] — the format
        evaluate.py writes (reference evaluate.py:182-232).
    """

    def __init__(self, gt: Dict, dt: Sequence[Dict],
                 sigmas: np.ndarray = COCO_SIGMAS,
                 img_ids: Optional[Sequence[int]] = None):
        self.sigmas = np.asarray(sigmas, np.float64)
        if img_ids is None:
            img_ids = sorted({im["id"] for im in gt.get("images", [])} or
                             {a["image_id"] for a in gt["annotations"]})
        self.img_ids = list(img_ids)

        self.gts: Dict[int, List[Dict]] = {i: [] for i in self.img_ids}
        for a in gt["annotations"]:
            if a["image_id"] not in self.gts:
                continue
            a = dict(a)
            kps = np.asarray(a["keypoints"], np.float64)
            if "num_keypoints" not in a:
                a["num_keypoints"] = int(np.count_nonzero(kps[2::3] > 0))
            if "bbox" not in a or "area" not in a:
                bbox, area = keypoints_bbox_area(kps)
                a.setdefault("bbox", bbox)
                a.setdefault("area", area)
            a.setdefault("iscrowd", 0)
            # keypoint-eval ignore rule: crowds and unlabeled people are
            # ignore regions, never true/false positives
            a["_ignore"] = int(bool(a.get("ignore", 0)) or a["iscrowd"] or
                               a["num_keypoints"] == 0)
            self.gts[a["image_id"]].append(a)

        self.dts: Dict[int, List[Dict]] = {i: [] for i in self.img_ids}
        for d in dt:
            if d["image_id"] not in self.dts:
                continue
            d = dict(d)
            kps = np.asarray(d["keypoints"], np.float64)
            if "area" not in d:
                d["bbox"], d["area"] = keypoints_bbox_area(kps)
            self.dts[d["image_id"]].append(d)
        for i in self.img_ids:   # score order, stable, truncated to maxDets
            ds = self.dts[i]
            order = np.argsort([-d["score"] for d in ds], kind="mergesort")
            self.dts[i] = [ds[k] for k in order][:MAX_DETS]

        self.stats: Optional[np.ndarray] = None
        self._eval_imgs: Dict = {}
        self._precision = None
        self._recall = None

    # -- per-image -----------------------------------------------------------
    def _ious(self, img_id: int) -> np.ndarray:
        gts, dts = self.gts[img_id], self.dts[img_id]
        ious = np.zeros((len(dts), len(gts)))
        for j, g in enumerate(gts):
            for i, d in enumerate(dts):
                ious[i, j] = compute_oks(
                    np.asarray(d["keypoints"], np.float64), g, self.sigmas)
        return ious

    def _evaluate_img(self, img_id: int, arng: tuple, ious: np.ndarray):
        gts, dts = self.gts[img_id], self.dts[img_id]
        if not gts and not dts:
            return None
        gt_ig = np.array([
            1 if (g["_ignore"] or g["area"] < arng[0] or g["area"] > arng[1])
            else 0 for g in gts], np.int32)
        # ignored gts sort to the back so real gts are matched first
        gtind = np.argsort(gt_ig, kind="mergesort")
        gts = [gts[k] for k in gtind]
        gt_ig = gt_ig[gtind]
        iscrowd = [int(g["iscrowd"]) for g in gts]
        ious_s = ious[:, gtind] if len(gts) else ious

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dtm = np.zeros((T, D), np.int64)
        gtm = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), np.int32)
        if G:
            for tind, t in enumerate(IOU_THRS):
                for dind in range(D):
                    best = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        # gt already claimed (crowds may match many dts)
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # past all real gts into ignores with a match in
                        # hand: stop
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                            break
                        if ious_s[dind, gind] < best:
                            continue
                        best = ious_s[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dt_ig[tind, dind] = gt_ig[m]
                    dtm[tind, dind] = m + 1
                    gtm[tind, m] = dind + 1
        # unmatched dts outside the area range are ignored, not FPs
        a_out = np.array([d["area"] < arng[0] or d["area"] > arng[1]
                          for d in dts], np.int32).reshape(1, D)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0,
                                                    np.repeat(a_out, T, 0)))
        return {
            "dtScores": np.array([d["score"] for d in dts]),
            "dtMatches": dtm, "dtIgnore": dt_ig,
            "numGt": int(np.count_nonzero(gt_ig == 0)),
        }

    # -- whole-dataset -------------------------------------------------------
    def evaluate(self):
        for img_id in self.img_ids:
            ious = self._ious(img_id)
            for aname, arng in AREA_RNG.items():
                self._eval_imgs[(aname, img_id)] = \
                    self._evaluate_img(img_id, arng, ious)
        return self

    def accumulate(self):
        T, R, A = len(IOU_THRS), len(REC_THRS), len(AREA_RNG)
        precision = -np.ones((T, R, A))
        recall = -np.ones((T, A))
        for aind, aname in enumerate(AREA_RNG):
            Es = [self._eval_imgs[(aname, i)] for i in self.img_ids]
            Es = [e for e in Es if e is not None]
            if not Es:
                continue
            scores = np.concatenate([e["dtScores"] for e in Es])
            order = np.argsort(-scores, kind="mergesort")
            dtm = np.concatenate([e["dtMatches"] for e in Es], 1)[:, order]
            dt_ig = np.concatenate([e["dtIgnore"] for e in Es], 1)[:, order]
            npig = sum(e["numGt"] for e in Es)
            if npig == 0:
                continue
            tps = np.logical_and(dtm != 0, np.logical_not(dt_ig))
            fps = np.logical_and(dtm == 0, np.logical_not(dt_ig))
            tp_sum = np.cumsum(tps, 1).astype(np.float64)
            fp_sum = np.cumsum(fps, 1).astype(np.float64)
            for t in range(T):
                tp, fp = tp_sum[t], fp_sum[t]
                nd = len(tp)
                rc = tp / npig
                pr = tp / (fp + tp + np.spacing(1))
                recall[t, aind] = rc[-1] if nd else 0.0
                q = np.zeros(R)
                pr = pr.tolist()
                for i in range(nd - 1, 0, -1):    # monotone interpolation
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                for ri, pi in enumerate(inds):
                    if pi < nd:
                        q[ri] = pr[pi]
                precision[t, :, aind] = q
        self._precision, self._recall = precision, recall
        return self

    def _sum(self, ap: bool, iou: Optional[float], area: str) -> float:
        aind = list(AREA_RNG).index(area)
        if ap:
            s = self._precision[:, :, aind]
        else:
            s = self._recall[:, aind]
        if iou is not None:
            s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def summarize(self, print_fn=print):
        spec = [
            (1, None, "all"), (1, 0.5, "all"), (1, 0.75, "all"),
            (1, None, "medium"), (1, None, "large"),
            (0, None, "all"), (0, 0.5, "all"), (0, 0.75, "all"),
            (0, None, "medium"), (0, None, "large"),
        ]
        self.stats = np.array([self._sum(bool(ap), iou, ar)
                               for ap, iou, ar in spec])
        if print_fn is not None:
            tmpl = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | "
                    "maxDets={:>3d} ] = {:0.3f}")
            for (ap, iou, ar), v in zip(spec, self.stats):
                name = "Average Precision" if ap else "Average Recall"
                abbr = "(AP)" if ap else "(AR)"
                iou_s = "0.50:0.95" if iou is None else f"{iou:0.2f}"
                print_fn(tmpl.format(name, abbr, iou_s, ar, MAX_DETS, v))
        return self.stats

    def run(self, print_fn=print) -> np.ndarray:
        """evaluate + accumulate + summarize; returns the 10 stats."""
        return self.evaluate().accumulate().summarize(print_fn)
