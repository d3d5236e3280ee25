"""Greedy keypoint-to-person assembly (host reference implementation).

The port's copy of ``improved_body_parts_tpu/ops/group.py``. Faithful
re-implementation of the reference's assembly semantics
(utils/parse_skeletons.py:413-600 ``find_humans``; same algorithm as the C++
``pafprocess`` extension, utils/pafprocess/pafprocess.cpp:132-283) operating
on the fixed-size connection tables produced on-device by
``ops.limbs.select_connections``.

The person table follows the reference layout: (num_persons, 20, 2) where
rows 0..17 hold [peak_id, connection_score] per joint type, row -2 holds
[accumulated_score, _], row -1 holds [part_count, max_limb_len].

The assembly is O(limb_types x connections x persons) over tiny tables
(tens of peaks), so a host pass is microseconds; a C++ fast path with
identical semantics lives in csrc/grouping.cpp (see ops/group_cpp.py),
and both are parity-tested against each other.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from improved_body_parts_tpu_torch.configs import LIMBS_CONN, NUM_PARTS, InferenceConfig


def build_joint_candidates(peaks_xy: np.ndarray, peaks_score: np.ndarray,
                           peaks_valid: np.ndarray) -> np.ndarray:
    """Flatten (K,P,...) peak tables into the (K*P, 4) candidate array
    [x, y, score, peak_id] with peak_id = joint_type * P + slot."""
    K, P = peaks_score.shape
    out = np.zeros((K * P, 4), np.float64)
    out[:, 0] = peaks_xy[..., 0].reshape(-1)
    out[:, 1] = peaks_xy[..., 1].reshape(-1)
    out[:, 2] = np.where(peaks_valid.reshape(-1), peaks_score.reshape(-1), 0.0)
    out[:, 3] = np.arange(K * P)
    return out


def find_humans(connected_limbs: Sequence[np.ndarray],
                joint_candidates: np.ndarray,
                cfg: InferenceConfig = InferenceConfig(),
                limbs_conn: np.ndarray = LIMBS_CONN) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble connections into persons.

    connected_limbs: per limb type, (k, 6) rows
      [src_peak_id, dst_peak_id, conn_score, src_idx, dst_idx, limb_len].
    Returns (person_table (N, 20, 2), joint_candidates).
    """
    len_rate = cfg.len_rate
    connection_tole = cfg.connection_tole
    delete_shared = cfg.remove_recon

    persons: List[np.ndarray] = []

    for limb_type in range(len(limbs_conn)):
        conns = connected_limbs[limb_type]
        if conns is None or len(conns) == 0:
            continue
        src_type, dst_type = int(limbs_conn[limb_type][0]), int(limbs_conn[limb_type][1])

        for row in conns:
            src_pid, dst_pid, conn_score = row[0], row[1], row[2]
            limb_len = row[-1]

            assoc = []
            for pi, p in enumerate(persons):
                if p[src_type, 0] == src_pid or p[dst_type, 0] == dst_pid:
                    if len(assoc) >= 2:
                        # reference prints an error and skips extras
                        continue
                    assoc.append(pi)

            if len(assoc) == 1:
                p = persons[assoc[0]]
                p_dst_pid = p[dst_type, 0]
                p_dst_score = p[dst_type, 1]
                p_max_len = p[-1, 1]
                if int(p_dst_pid) == -1 and p_max_len * len_rate > limb_len:
                    # dst joint unset for this person: claim it
                    p[dst_type] = [dst_pid, conn_score]
                    p[-1, 0] += 1
                    p[-1, 1] = max(limb_len, p_max_len)
                    p[-2, 0] += joint_candidates[int(dst_pid), 2] + conn_score
                elif (int(p_dst_pid) != int(dst_pid)
                      and p_dst_score <= conn_score
                      and p_max_len * len_rate > limb_len):
                    # replace a lower-scored different dst joint
                    p[-2, 0] -= joint_candidates[int(p_dst_pid), 2] + p_dst_score
                    p[dst_type] = [dst_pid, conn_score]
                    p[-1, 1] = max(limb_len, p_max_len)
                    p[-2, 0] += joint_candidates[int(dst_pid), 2] + conn_score
                elif (int(p_dst_pid) == int(dst_pid)
                      and p_dst_score <= conn_score):
                    # same dst joint seen again with a better score
                    p[-2, 0] -= joint_candidates[int(p_dst_pid), 2] + p_dst_score
                    p[dst_type] = [dst_pid, conn_score]
                    p[-1, 1] = max(limb_len, p_max_len)
                    p[-2, 0] += joint_candidates[int(dst_pid), 2] + conn_score

            elif len(assoc) == 2:
                p1 = persons[assoc[0]]
                p2 = persons[assoc[1]]
                p1_max_len = p1[-1, 1]
                member1 = (p1[:-2, 0] >= 0).astype(int)
                member2 = (p2[:-2, 0] >= 0).astype(int)
                if not np.any(member1 + member2 == 2):
                    # disjoint: merge p2 into p1 when confident enough
                    min1 = np.min(p1[:-2, 1][member1 == 1])
                    min2 = np.min(p2[:-2, 1][member2 == 1])
                    if (conn_score >= connection_tole * min(min1, min2)
                            and limb_len < p1_max_len * len_rate):
                        p1[:-2] = np.maximum(p1[:-2], p2[:-2])
                        p1[-1, 0] += p2[-1, 0]
                        p1[-1, 1] = max(limb_len, p1_max_len)
                        p1[-2, 0] += p2[-2, 0] + conn_score
                        del persons[assoc[1]]
                elif delete_shared:
                    # a joint is claimed by two persons: drop the weaker claim
                    p1_pids = p1[:-2, 0]
                    p2_pids = p2[:-2, 0]
                    if src_pid in p1_pids:
                        c1 = int(np.flatnonzero(p1_pids == src_pid)[0])
                        c2 = int(np.flatnonzero(p2_pids == dst_pid)[0])
                    else:
                        c1 = int(np.flatnonzero(p1_pids == dst_pid)[0])
                        c2 = int(np.flatnonzero(p2_pids == src_pid)[0])
                    if conn_score >= p1[c1, 1] and conn_score >= p2[c2, 1]:
                        if p1[c1, 1] > p2[c2, 1]:
                            low, del_c = assoc[1], c2
                        else:
                            low, del_c = assoc[0], c1
                        lp = persons[low]
                        lp[-2, 0] -= joint_candidates[int(lp[del_c, 0]), 2] + lp[del_c, 1]
                        lp[del_c, 0] = -1
                        lp[del_c, 1] = -1
                        lp[-1, 0] -= 1

            else:
                # nobody claimed these joints: spawn a new person
                p = -1 * np.ones((NUM_PARTS + 2, 2))
                p[src_type] = [src_pid, conn_score]
                p[dst_type] = [dst_pid, conn_score]
                p[-1] = [2, limb_len]
                p[-2, 0] = (joint_candidates[int(src_pid), 2]
                            + joint_candidates[int(dst_pid), 2] + conn_score)
                persons.append(p)

    # cull: too few parts or too low mean score (parse_skeletons.py:593-598)
    kept = [p for p in persons
            if p[-1, 0] >= cfg.min_person_parts
            and p[-2, 0] / p[-1, 0] >= cfg.min_person_score]
    if kept:
        table = np.stack(kept, axis=0)
    else:
        table = np.zeros((0, NUM_PARTS + 2, 2))
    return table, joint_candidates


def humans_to_keypoints(person_table: np.ndarray,
                        joint_candidates: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Extract per-person keypoints and scores.

    Returns (keypoints (N, 18, 3) with [x, y, visible], scores (N,)) where
    score = accumulated_score / part_count — the reference's improved
    ``score/count`` formula worth +0.3 AP (evaluate.py:151, README.md:24-26).
    """
    n = len(person_table)
    kps = np.zeros((n, NUM_PARTS, 3), np.float64)
    scores = np.zeros((n,), np.float64)
    for i, p in enumerate(person_table):
        for j in range(NUM_PARTS):
            pid = int(p[j, 0])
            if pid >= 0:
                x, y = joint_candidates[pid, 0], joint_candidates[pid, 1]
                kps[i, j] = [x, y, 1.0 if (x > 0 or y > 0) else 0.0]
        scores[i] = p[-2, 0] / p[-1, 0]
    return kps, scores
