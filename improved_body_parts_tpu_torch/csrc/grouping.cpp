// Greedy keypoint-to-person assembly — native host fast path.
//
// The port's copy of the JAX package's src/cpp/grouping.cpp, built by
// ops/group_cpp.py with g++ (not nvcc: ops/build.py compiles only *.cu).
// C++ counterpart of ops/group.py (same semantics; held against the JAX
// package's library in tests/test_torch_shared.py). Plays the role the SWIG-wrapped
// pafprocess extension plays in the reference (utils/pafprocess/
// pafprocess.cpp:132-283) but with a clean C ABI for ctypes, no global
// mutable state, and the skeleton topology passed in from the single Python
// config source (the reference duplicated its constants between an INI file
// and the C++ header, pafprocess.h:6-17).
//
// Person table layout (reference convention): rows 0..17 = [peak_id,
// connection_score] per joint type, row 18 = [accumulated_score, unused],
// row 19 = [part_count, max_limb_len].

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumParts = 18;
constexpr int kRows = kNumParts + 2;  // 20

struct Person {
  double data[kRows][2];
  Person() {
    for (int r = 0; r < kRows; ++r) {
      data[r][0] = -1.0;
      data[r][1] = -1.0;
    }
  }
  double* operator[](int r) { return data[r]; }
  const double* operator[](int r) const { return data[r]; }
};

}  // namespace

extern "C" {

// conns: (n_conns, 7) rows [limb_type, src_peak_id, dst_peak_id, score,
//        src_idx, dst_idx, limb_len], sorted by limb_type ascending with
//        per-type order preserved.
// cands: (n_cands, 4) rows [x, y, score, peak_id].
// limb_from/limb_to: (n_limb_types,) joint-type ids per limb type.
// out_table: caller-allocated (max_out * 20 * 2) doubles.
// Returns the number of persons written, or -1 if max_out was too small.
int ibp_find_humans(const double* conns, int n_conns,
                    const double* cands, int n_cands,
                    const int* limb_from, const int* limb_to, int n_limb_types,
                    double len_rate, double connection_tole, int delete_shared,
                    int min_parts, double min_score,
                    double* out_table, int max_out) {
  std::vector<Person> persons;
  persons.reserve(64);

  auto cand_score = [&](double pid) -> double {
    int idx = static_cast<int>(pid);
    if (idx < 0 || idx >= n_cands) return 0.0;
    return cands[idx * 4 + 2];
  };

  for (int ci = 0; ci < n_conns; ++ci) {
    const double* row = conns + ci * 7;
    const int limb_type = static_cast<int>(row[0]);
    if (limb_type < 0 || limb_type >= n_limb_types) continue;
    const int src_type = limb_from[limb_type];
    const int dst_type = limb_to[limb_type];
    const double src_pid = row[1];
    const double dst_pid = row[2];
    const double conn_score = row[3];
    const double limb_len = row[6];

    int assoc[2] = {-1, -1};
    int n_assoc = 0;
    for (size_t pi = 0; pi < persons.size(); ++pi) {
      const Person& p = persons[pi];
      if (p[src_type][0] == src_pid || p[dst_type][0] == dst_pid) {
        if (n_assoc >= 2) continue;  // reference skips extras
        assoc[n_assoc++] = static_cast<int>(pi);
      }
    }

    if (n_assoc == 1) {
      Person& p = persons[assoc[0]];
      const double p_dst_pid = p[dst_type][0];
      const double p_dst_score = p[dst_type][1];
      const double p_max_len = p[kRows - 1][1];
      if (static_cast<int>(p_dst_pid) == -1 && p_max_len * len_rate > limb_len) {
        p[dst_type][0] = dst_pid;
        p[dst_type][1] = conn_score;
        p[kRows - 1][0] += 1.0;
        p[kRows - 1][1] = std::max(limb_len, p_max_len);
        p[kRows - 2][0] += cand_score(dst_pid) + conn_score;
      } else if (static_cast<int>(p_dst_pid) != static_cast<int>(dst_pid) &&
                 p_dst_score <= conn_score && p_max_len * len_rate > limb_len) {
        p[kRows - 2][0] -= cand_score(p_dst_pid) + p_dst_score;
        p[dst_type][0] = dst_pid;
        p[dst_type][1] = conn_score;
        p[kRows - 1][1] = std::max(limb_len, p_max_len);
        p[kRows - 2][0] += cand_score(dst_pid) + conn_score;
      } else if (static_cast<int>(p_dst_pid) == static_cast<int>(dst_pid) &&
                 p_dst_score <= conn_score) {
        p[kRows - 2][0] -= cand_score(p_dst_pid) + p_dst_score;
        p[dst_type][0] = dst_pid;
        p[dst_type][1] = conn_score;
        p[kRows - 1][1] = std::max(limb_len, p_max_len);
        p[kRows - 2][0] += cand_score(dst_pid) + conn_score;
      }
    } else if (n_assoc == 2) {
      Person& p1 = persons[assoc[0]];
      Person& p2 = persons[assoc[1]];
      const double p1_max_len = p1[kRows - 1][1];
      bool overlap = false;
      for (int j = 0; j < kNumParts; ++j) {
        if (p1[j][0] >= 0 && p2[j][0] >= 0) {
          overlap = true;
          break;
        }
      }
      if (!overlap) {
        double min1 = 1e30, min2 = 1e30;
        for (int j = 0; j < kNumParts; ++j) {
          if (p1[j][0] >= 0) min1 = std::min(min1, p1[j][1]);
          if (p2[j][0] >= 0) min2 = std::min(min2, p2[j][1]);
        }
        if (conn_score >= connection_tole * std::min(min1, min2) &&
            limb_len < p1_max_len * len_rate) {
          for (int j = 0; j < kNumParts; ++j) {
            p1[j][0] = std::max(p1[j][0], p2[j][0]);
            p1[j][1] = std::max(p1[j][1], p2[j][1]);
          }
          p1[kRows - 1][0] += p2[kRows - 1][0];
          p1[kRows - 1][1] = std::max(limb_len, p1_max_len);
          p1[kRows - 2][0] += p2[kRows - 2][0] + conn_score;
          persons.erase(persons.begin() + assoc[1]);
        }
      } else if (delete_shared) {
        int c1 = -1, c2 = -1;
        bool src_in_p1 = false;
        for (int j = 0; j < kNumParts; ++j)
          if (p1[j][0] == src_pid) src_in_p1 = true;
        if (src_in_p1) {
          for (int j = 0; j < kNumParts; ++j) {
            if (p1[j][0] == src_pid && c1 < 0) c1 = j;
            if (p2[j][0] == dst_pid && c2 < 0) c2 = j;
          }
        } else {
          for (int j = 0; j < kNumParts; ++j) {
            if (p1[j][0] == dst_pid && c1 < 0) c1 = j;
            if (p2[j][0] == src_pid && c2 < 0) c2 = j;
          }
        }
        if (c1 >= 0 && c2 >= 0 && conn_score >= p1[c1][1] &&
            conn_score >= p2[c2][1]) {
          Person* low;
          int del_c;
          if (p1[c1][1] > p2[c2][1]) {
            low = &p2;
            del_c = c2;
          } else {
            low = &p1;
            del_c = c1;
          }
          (*low)[kRows - 2][0] -= cand_score((*low)[del_c][0]) + (*low)[del_c][1];
          (*low)[del_c][0] = -1.0;
          (*low)[del_c][1] = -1.0;
          (*low)[kRows - 1][0] -= 1.0;
        }
      }
    } else {
      Person p;
      p[src_type][0] = src_pid;
      p[src_type][1] = conn_score;
      p[dst_type][0] = dst_pid;
      p[dst_type][1] = conn_score;
      p[kRows - 1][0] = 2.0;
      p[kRows - 1][1] = limb_len;
      p[kRows - 2][0] = cand_score(src_pid) + cand_score(dst_pid) + conn_score;
      persons.push_back(p);
    }
  }

  int n_out = 0;
  for (const Person& p : persons) {
    if (p[kRows - 1][0] < min_parts ||
        p[kRows - 2][0] / p[kRows - 1][0] < min_score)
      continue;
    if (n_out >= max_out) return -1;
    std::memcpy(out_table + n_out * kRows * 2, p.data, sizeof(p.data));
    ++n_out;
  }
  return n_out;
}

}  // extern "C"
