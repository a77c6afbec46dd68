// Native topology passes — bit-exact with the Python reference
// implementations in torchdraco/models/corner_table.py,
// torchdraco/shared/sequencer.py, torchdraco/encode/connectivity.py and
// torchdraco/ops/gathers.py (which mirror draco-oxide; see those files for
// reference citations). Every function has a Python fallback.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {
constexpr int64_t NONE = -1;

inline int64_t next_c(int64_t c) { return c % 3 == 2 ? c - 2 : c + 1; }
inline int64_t prev_c(int64_t c) { return c % 3 == 0 ? c + 2 : c - 1; }

struct Nav {
    const int64_t* opp;
    inline int64_t swing_left(int64_t c) const {
        int64_t o = opp[next_c(c)];
        return o != NONE ? next_c(o) : NONE;
    }
    inline int64_t swing_right(int64_t c) const {
        int64_t o = opp[prev_c(c)];
        return o != NONE ? prev_c(o) : NONE;
    }
};
}  // namespace

extern "C" {

// Half-edge matching (corner_table.py _compute_table). opposite must be
// pre-filled with NONE.
void tdn_compute_table(const int64_t* ctv, int64_t C, int64_t V,
                        int64_t* opposite) {
    std::vector<int64_t> counts(V, 0);
    for (int64_t c = 0; c < C; ++c) counts[ctv[c]]++;
    std::vector<int64_t> offsets(V, 0);
    int64_t acc = 0;
    for (int64_t v = 0; v < V; ++v) { offsets[v] = acc; acc += counts[v]; }

    std::vector<int64_t> edge_sink(C, NONE), edge_corner(C, NONE);
    for (int64_t c = 0; c < C; ++c) {
        const int64_t tip_v = ctv[c];
        const int64_t source_v = ctv[next_c(c)];
        const int64_t sink_v = ctv[prev_c(c)];
        if (c % 3 == 0 && (tip_v == source_v || tip_v == sink_v ||
                           source_v == sink_v))
            continue;
        int64_t opposite_c = NONE;
        const int64_t n_on_sink = counts[sink_v];
        int64_t off = offsets[sink_v];
        for (int64_t i = 0; i < n_on_sink; ++i) {
            const int64_t other_v = edge_sink[off];
            if (other_v == NONE) break;
            if (other_v == source_v) {
                if (tip_v == ctv[edge_corner[off]]) break;  // quirk
                opposite_c = edge_corner[off];
                const int64_t base = offsets[sink_v];
                for (int64_t k = 1; k < n_on_sink - (off - base); ++k) {
                    edge_sink[off] = edge_sink[off + 1];
                    edge_corner[off] = edge_corner[off + 1];
                    if (edge_sink[off] == NONE) break;
                    ++off;
                }
                edge_sink[off] = NONE;
                break;
            }
            ++off;
        }
        if (opposite_c == NONE) {
            const int64_t first = offsets[source_v];
            for (int64_t slot = first; slot < first + counts[source_v]; ++slot) {
                if (edge_sink[slot] == NONE) {
                    edge_sink[slot] = sink_v;
                    edge_corner[slot] = c;
                    break;
                }
            }
        } else {
            opposite[c] = opposite_c;
            opposite[opposite_c] = c;
        }
    }
}

// Returns 1 when an edge is shared by more than 2 faces.
int32_t tdn_has_non_manifold_edges(const int64_t* ctv, int64_t C) {
    // counting-bucket multiplicity check: half-edges bucket by their min
    // endpoint (one counting-sort pass), then each small bucket (~valence
    // entries) is scanned for a >2 run. Replaces a global O(C log C) sort
    // of 64-bit keys with O(C) passes + tiny per-bucket sorts (~4x at 2M
    // faces; the global sort was 0.3 s of a 2 s encode).
    int64_t V = 0;
    for (int64_t c = 0; c < C; ++c) V = std::max(V, ctv[c]);
    ++V;
    std::vector<int64_t> counts(V + 1, 0);
    for (int64_t f = 0; f < C / 3; ++f) {
        for (int k = 0; k < 3; ++k) {
            const int64_t a = ctv[3 * f + k], b = ctv[3 * f + (k + 1) % 3];
            counts[(a < b ? a : b) + 1]++;
        }
    }
    for (int64_t v = 0; v < V; ++v) counts[v + 1] += counts[v];
    std::vector<int64_t> other(C);
    std::vector<int64_t> fill(counts.begin(), counts.end() - 1);
    for (int64_t f = 0; f < C / 3; ++f) {
        for (int k = 0; k < 3; ++k) {
            int64_t a = ctv[3 * f + k], b = ctv[3 * f + (k + 1) % 3];
            if (a > b) std::swap(a, b);
            other[fill[a]++] = b;
        }
    }
    for (int64_t v = 0; v < V; ++v) {
        const int64_t s = counts[v], e = counts[v + 1];
        if (e - s < 3) continue;  // a >2 run needs >= 3 bucket entries
        std::sort(other.begin() + s, other.begin() + e);
        int run = 1;
        for (int64_t i = s + 1; i < e; ++i) {
            if (other[i] == other[i - 1]) {
                if (++run > 2) return 1;
            } else {
                run = 1;
            }
        }
    }
    return 0;
}

// Break connectivity at non-manifold edges (corner_table.py
// _handle_non_manifold_edges).
void tdn_break_non_manifold_edges(int64_t* opposite, const int64_t* ctv,
                                   int64_t C) {
    Nav nav{opposite};
    std::vector<uint8_t> visited(C, 0);
    std::vector<int64_t> sink_v_list, sink_c_list;
    for (;;) {
        bool connectivity_updated = false;
        for (int64_t c = 0; c < C; ++c) {
            if (visited[c]) continue;
            sink_v_list.clear();
            sink_c_list.clear();
            int64_t first_c = c, curr_c = c;
            int64_t nxt = nav.swing_left(curr_c);
            while (nxt != NONE && nxt != first_c && !visited[nxt]) {
                curr_c = nxt;
                nxt = nav.swing_left(curr_c);
            }
            first_c = curr_c;
            for (;;) {
                visited[curr_c] = 1;
                const int64_t sink_c = next_c(curr_c);
                const int64_t sink_v = ctv[sink_c];
                const int64_t edge_c = prev_c(curr_c);
                bool updated = false;
                for (size_t i = 0; i < sink_v_list.size(); ++i) {
                    if (sink_v_list[i] != sink_v) continue;
                    const int64_t other_edge_c = sink_c_list[i];
                    const int64_t opp_edge_c = opposite[edge_c];
                    if (opp_edge_c != NONE && opp_edge_c == other_edge_c)
                        continue;
                    const int64_t opp_other = opposite[other_edge_c];
                    if (opp_edge_c != NONE) opposite[opp_edge_c] = NONE;
                    if (opp_other != NONE) opposite[opp_other] = NONE;
                    opposite[edge_c] = NONE;
                    opposite[other_edge_c] = NONE;
                    updated = true;
                    break;
                }
                if (updated) { connectivity_updated = true; break; }
                sink_v_list.push_back(ctv[prev_c(curr_c)]);
                sink_c_list.push_back(sink_c);
                curr_c = nav.swing_right(curr_c);
                if (curr_c == NONE || curr_c == first_c) break;
            }
        }
        if (!connectivity_updated) break;
    }
}

// Left-most corners + non-manifold vertex duplication (corner_table.py
// _compute_left_most_corners). ctv is mutated for split vertices;
// left_most must have capacity V + C; parents capacity C.
// Returns the new vertex count.
int64_t tdn_left_most(int64_t* ctv, const int64_t* opposite, int64_t C,
                       int64_t V, int64_t* left_most, int64_t* parents,
                       int64_t* num_parents) {
    Nav nav{opposite};
    std::vector<uint8_t> visited_vertices(V + C, 0);
    std::vector<uint8_t> visited_corners(C, 0);
    int64_t num_vertices = V;
    int64_t n_par = 0;
    for (int64_t i = 0; i < V; ++i) left_most[i] = NONE;
    for (int64_t c = 0; c < C; ++c) {
        if (visited_corners[c]) continue;
        int64_t v = ctv[c];
        bool is_nm = false;
        if (visited_vertices[v]) {
            left_most[num_vertices] = NONE;
            parents[n_par++] = v;
            v = num_vertices++;
            is_nm = true;
        }
        visited_vertices[v] = 1;
        visited_corners[c] = 1;
        left_most[v] = c;
        if (is_nm) ctv[c] = v;
        int64_t act = nav.swing_left(c);
        bool hit_start = false;
        while (act != NONE) {
            if (act == c) { hit_start = true; break; }
            visited_corners[act] = 1;
            left_most[v] = act;
            if (is_nm) ctv[act] = v;
            act = nav.swing_left(act);
        }
        if (!hit_start) {
            act = c;
            while (act != NONE) {
                visited_corners[act] = 1;
                if (is_nm) ctv[act] = v;
                act = nav.swing_right(act);
            }
        }
    }
    *num_parents = n_par;
    return num_vertices;
}

// Attribute traversal sequencer (shared/sequencer.py compute_sequence).
// opposite is the *effective* opposite (seam-masked for attribute tables).
// Returns the sequence length written to out_corners (capacity num_vertices).
int64_t tdn_sequence(const int64_t* opposite, const int64_t* ctv,
                      const int64_t* left_most, int64_t C, int64_t V,
                      const int64_t* init_stack, int64_t init_len,
                      int64_t* out_corners) {
    Nav nav{opposite};
    std::vector<uint8_t> visited_vertices(V, 0);
    std::vector<uint8_t> visited_faces(C / 3, 0);
    int64_t out_n = 0;

    // flat per-face pending-entry lists + serial-indexed dead flags: the
    // hashed versions dominated the whole encode profile
    struct Entry { int64_t corner; int64_t serial; };
    std::vector<Entry> stack;
    stack.reserve(init_len + 64);
    const int64_t F = C / 3;
    std::vector<std::vector<int64_t>> face_entries(F);
    std::vector<uint8_t> dead;
    dead.reserve(init_len + C);
    int64_t serial = 0;
    auto push = [&](int64_t c) {
        stack.push_back({c, serial});
        face_entries[c / 3].push_back(serial);
        dead.push_back(0);
        ++serial;
    };
    for (int64_t i = 0; i < init_len; ++i) push(init_stack[i]);
    auto prune = [&](int64_t face_idx) {
        auto& ids = face_entries[face_idx];
        for (int64_t s : ids) dead[s] = 1;
        ids.clear();
    };
    auto visit = [&](int64_t v, int64_t c) {
        if (!visited_vertices[v]) out_corners[out_n++] = c;
        visited_vertices[v] = 1;
    };

    while (!stack.empty()) {
        Entry e = stack.back();
        stack.pop_back();
        if (dead[e.serial]) continue;
        {
            auto& ids = face_entries[e.corner / 3];
            for (size_t i = 0; i < ids.size(); ++i) {
                if (ids[i] == e.serial) { ids.erase(ids.begin() + i); break; }
            }
        }
        const int64_t curr = e.corner;
        if (visited_faces[curr / 3]) continue;
        const int64_t v = ctv[curr];
        const int64_t nc = next_c(curr), pc = prev_c(curr);
        const int64_t nv = ctv[nc], pv = ctv[pc];
        if (!visited_vertices[nv] || !visited_vertices[pv]) {
            visit(nv, nc);
            visit(pv, pc);
            push(curr);
            continue;
        }
        const int64_t face_idx = curr / 3;
        visited_faces[face_idx] = 1;
        if (!visited_vertices[v]) {
            visit(v, curr);
            // is_on_boundary(v): seam-aware swing-left from left-most
            const int64_t lm = left_most[v];
            if (nav.swing_left(lm) != NONE) {
                push(opposite[next_c(curr)]);  // get_right_corner
                continue;
            }
        }
        visit(v, curr);
        const int64_t right_cn = opposite[next_c(curr)];
        const int64_t left_cn = opposite[prev_c(curr)];
        const bool right_vis = right_cn != NONE && visited_faces[right_cn / 3];
        const bool left_vis = left_cn != NONE && visited_faces[left_cn / 3];
        if (right_vis) {
            prune(face_idx);
            if (!left_vis && left_cn != NONE) push(left_cn);
        } else if (left_vis) {
            prune(face_idx);
            if (right_cn != NONE) push(right_cn);
        } else {
            if (left_cn != NONE) push(left_cn);
            if (right_cn != NONE) push(right_cn);
        }
    }
    return out_n;
}

// Parallelogram prediction gathers (ops/gathers.py). val_of_corner maps a
// corner to its attribute-value index.
void tdn_parallelogram_gathers(
        const int64_t* opposite, const int64_t* ctv, const int64_t* left_most,
        const int64_t* val_of_corner, const int64_t* seq, int64_t T,
        int64_t V, int32_t* order, int32_t* g_next, int32_t* g_prev,
        int32_t* g_opp, int32_t* g_fb, uint8_t* can_para, uint8_t* has_fb) {
    std::vector<uint8_t> visited(V, 0);
    int64_t last_v = -1;
    for (int64_t k = 0; k < T; ++k) {
        const int64_t c = seq[k];
        order[k] = (int32_t)val_of_corner[c];
        g_next[k] = g_prev[k] = g_opp[k] = g_fb[k] = 0;
        can_para[k] = 0;
        has_fb[k] = 0;
        const int64_t opp = opposite[c];
        if (opp != NONE) {
            const int64_t nc = next_c(c), pc = prev_c(c);
            if (visited[ctv[opp]] && visited[ctv[nc]] && visited[ctv[pc]]) {
                can_para[k] = 1;
                g_next[k] = (int32_t)val_of_corner[nc];
                g_prev[k] = (int32_t)val_of_corner[pc];
                g_opp[k] = (int32_t)val_of_corner[opp];
            }
        }
        if (!can_para[k] && last_v >= 0) {
            has_fb[k] = 1;
            g_fb[k] = (int32_t)val_of_corner[left_most[last_v]];
        }
        const int64_t v = ctv[c];
        visited[v] = 1;
        last_v = v;
    }
}

// Sequential decode chain: parallelogram/delta prediction + difference or
// wrapped-difference inverse transform (decode/attribute.py). corr holds
// zigzagged residuals (T x N); values_by_vertex (V x N) is filled along the
// traversal. scheme: 0 = delta, 1 = parallelogram; xform: 0 = difference,
// 1 = wrapped difference.
int32_t tdn_decode_pred_transform(
        const int64_t* opposite, const int64_t* ctv, const int64_t* left_most,
        const int64_t* seq, int64_t T, const uint64_t* corr, int32_t N,
        int32_t scheme, int32_t xform, int64_t vmin, int64_t vmax,
        int64_t V, int64_t* values_by_vertex) {
    std::vector<uint8_t> visited(V, 0);
    int64_t last_v = -1;
    const int64_t max_diff = 1 + vmax - vmin;
    int64_t pred[8];
    for (int64_t k = 0; k < T; ++k) {
        const int64_t c = seq[k];
        bool have_pred = false;
        if (scheme == 1) {
            const int64_t opp = opposite[c];
            if (opp != NONE) {
                const int64_t nv = ctv[next_c(c)], pv = ctv[prev_c(c)];
                const int64_t ov = ctv[opp];
                if (visited[ov] && visited[nv] && visited[pv]) {
                    for (int32_t i = 0; i < N; ++i)
                        pred[i] = values_by_vertex[nv * N + i]
                                  + values_by_vertex[pv * N + i]
                                  - values_by_vertex[ov * N + i];
                    have_pred = true;
                }
            }
        }
        if (!have_pred) {
            if (last_v >= 0) {
                const int64_t fv = ctv[left_most[last_v]];
                for (int32_t i = 0; i < N; ++i)
                    pred[i] = values_by_vertex[fv * N + i];
            } else {
                for (int32_t i = 0; i < N; ++i) pred[i] = 0;
            }
        }
        const int64_t v = ctv[c];
        for (int32_t i = 0; i < N; ++i) {
            const uint64_t u = corr[k * N + i];
            const int64_t delta = (u & 1) ? -(int64_t)(u >> 1) - 1
                                          : (int64_t)(u >> 1);
            int64_t p = pred[i];
            if (xform == 1) {
                if (p < vmin) p = vmin;
                if (p > vmax) p = vmax;
                int64_t t = p + delta;
                if (t > vmax) t -= max_diff;
                else if (t < vmin) t += max_diff;
                values_by_vertex[v * N + i] = t;
            } else {
                values_by_vertex[v * N + i] = p + delta;
            }
        }
        visited[v] = 1;
        last_v = v;
    }
    return 0;
}

// Edgebreaker DFS (encode/connectivity.py EdgebreakerEncoder).
// Outputs (capacities): symbols[F], processed[F], interior_cfg[F],
// init_face_corners[F], splits 3*F (merge, split, orient triples),
// vertex_hole_id[V].  Returns 0 on success.
int32_t tdn_edgebreaker(const int64_t* opposite, const int64_t* ctv,
                         int64_t C, int64_t V,
                         uint8_t* symbols, int64_t* num_symbols,
                         int64_t* processed,
                         uint8_t* interior_cfg, int64_t* num_components,
                         int64_t* init_face_corners, int64_t* num_init,
                         int64_t* splits, int64_t* num_splits_out,
                         int64_t* num_split_symbols_out,
                         int64_t* vertex_hole_id) {
    Nav nav{opposite};
    const int64_t F = C / 3;
    std::vector<uint8_t> visited_vertices(V, 0);
    std::vector<uint8_t> visited_faces(F, 0);
    std::vector<uint8_t> visited_holes;
    for (int64_t v = 0; v < V; ++v) vertex_hole_id[v] = NONE;

    // compute boundaries
    for (int64_t c = 0; c < C; ++c) {
        if (opposite[c] != NONE) continue;
        int64_t v = ctv[next_c(c)];
        if (vertex_hole_id[v] != NONE) continue;
        const int64_t boundary_idx = (int64_t)visited_holes.size();
        visited_holes.push_back(0);
        int64_t cc = c;
        while (vertex_hole_id[v] == NONE) {
            vertex_hole_id[v] = boundary_idx;
            cc = next_c(cc);
            while (opposite[cc] != NONE) cc = next_c(opposite[cc]);
            v = ctv[next_c(cc)];
        }
    }

    auto process_boundary = [&](int64_t start_corner, bool encode_first) {
        int64_t corner = prev_c(start_corner);
        while (opposite[corner] != NONE) corner = next_c(opposite[corner]);
        const int64_t start_v = ctv[start_corner];
        if (encode_first) visited_vertices[start_v] = 1;
        visited_holes[vertex_hole_id[start_v]] = 1;
        int64_t curr_v = ctv[prev_c(corner)];
        while (curr_v != start_v) {
            visited_vertices[curr_v] = 1;
            corner = next_c(corner);
            while (opposite[corner] != NONE) corner = next_c(opposite[corner]);
            curr_v = ctv[prev_c(corner)];
        }
    };

    std::unordered_map<int64_t, int64_t> face_to_split;
    std::vector<int64_t> corner_stack;
    int64_t n_sym = 0, n_comp = 0, n_init = 0, n_splits = 0;
    int64_t n_split_symbols = 0;
    int64_t last_symbol_idx = -1;

    auto check_split = [&](int64_t merge_idx, int64_t orient, int64_t face) {
        auto it = face_to_split.find(face);
        if (it != face_to_split.end()) {
            splits[3 * n_splits] = merge_idx;
            splits[3 * n_splits + 1] = it->second;
            splits[3 * n_splits + 2] = orient;
            ++n_splits;
        }
    };

    // symbol ids: C=0 S=1 L=2 R=3 E=4 (shared/clers.py)
    auto edgebreaker_from = [&](int64_t c0) {
        corner_stack.clear();
        corner_stack.push_back(c0);
        while (!corner_stack.empty()) {
            int64_t c = corner_stack.back();
            if (visited_faces[c / 3]) { corner_stack.pop_back(); continue; }
            int64_t guard = 0;
            while (guard++ < F) {
                ++last_symbol_idx;
                const int64_t face_idx = c / 3;
                visited_faces[face_idx] = 1;
                processed[n_sym] = c;
                const int64_t v = ctv[c];
                if (!visited_vertices[v]) {
                    visited_vertices[v] = 1;
                    if (vertex_hole_id[v] == NONE) {
                        symbols[n_sym++] = 0;  // C
                        c = opposite[next_c(c)];  // get_right_corner
                        continue;
                    }
                }
                const int64_t right_c = opposite[next_c(c)];
                const int64_t left_c = opposite[prev_c(c)];
                const bool right_vis =
                    right_c == NONE || visited_faces[right_c / 3];
                const bool left_vis =
                    left_c == NONE || visited_faces[left_c / 3];
                if (right_vis) {
                    if (right_c != NONE)
                        check_split(last_symbol_idx, 1, right_c / 3);
                    if (left_vis) {
                        if (left_c != NONE)
                            check_split(last_symbol_idx, 0, left_c / 3);
                        symbols[n_sym++] = 4;  // E
                        corner_stack.pop_back();
                        break;
                    }
                    symbols[n_sym++] = 3;  // R
                    c = left_c;
                } else if (left_vis) {
                    if (left_c != NONE)
                        check_split(last_symbol_idx, 0, left_c / 3);
                    symbols[n_sym++] = 2;  // L
                    c = right_c;
                } else {
                    symbols[n_sym++] = 1;  // S
                    ++n_split_symbols;
                    const int64_t hole = vertex_hole_id[v];
                    if (hole != NONE && !visited_holes[hole])
                        process_boundary(c, false);
                    face_to_split[face_idx] = last_symbol_idx;
                    corner_stack.back() = left_c;
                    corner_stack.push_back(right_c);
                    break;
                }
            }
        }
    };

    for (int64_t c = 0; c < C; ++c) {
        const int64_t face_idx = c / 3;
        if (visited_faces[face_idx]) continue;
        // begin_from
        int64_t corner = 3 * face_idx;
        bool is_interior = true;
        int64_t start_corner = corner;
        for (int k = 0; k < 3; ++k) {
            if (opposite[corner] == NONE) {
                is_interior = false;
                start_corner = corner;
                break;
            }
            if (vertex_hole_id[ctv[corner]] != NONE) {
                int64_t right = corner;
                while (right != NONE) {
                    corner = right;
                    right = nav.swing_right(right);
                }
                is_interior = false;
                start_corner = prev_c(corner);
                break;
            }
            corner = next_c(corner);
        }
        if (is_interior) start_corner = corner;
        interior_cfg[n_comp++] = is_interior ? 1 : 0;
        if (is_interior) {
            visited_vertices[ctv[start_corner]] = 1;
            visited_vertices[ctv[next_c(start_corner)]] = 1;
            visited_vertices[ctv[prev_c(start_corner)]] = 1;
            visited_faces[face_idx] = 1;
            init_face_corners[n_init++] = next_c(start_corner);
            edgebreaker_from(opposite[next_c(start_corner)]);
        } else {
            process_boundary(next_c(start_corner), true);
            edgebreaker_from(start_corner);
        }
    }
    *num_symbols = n_sym;
    *num_components = n_comp;
    *num_init = n_init;
    *num_splits_out = n_splits;
    *num_split_symbols_out = n_split_symbols;
    return 0;
}

// Seam-splitting vertex recomputation for attribute corner tables
// (models/corner_table.py recompute_attribute_vertices; reference
// attribute_corner_table.rs:79-137). Sequential swing walks per vertex.
// Returns num_new_vertices, or -1 on a closed seam-vertex loop.
int64_t tdn_recompute_attribute_vertices(
        const int64_t* opposite, const int64_t* points, const int64_t* lm,
        const uint8_t* edge_seam, const uint8_t* vertex_seam,
        const int64_t* att_unique_of_point, int32_t has_v2a,
        int64_t C, int64_t V,
        int64_t* corner_to_vertex, int64_t* left_most_out, int64_t* v2a_out) {
    Nav nav{opposite};
    int64_t num_new = 0;
    for (int64_t v = 0; v < V; ++v) {
        const int64_t c0 = lm[v];
        int64_t first_vert_id = num_new++;
        if (has_v2a) v2a_out[first_vert_id] = att_unique_of_point[points[c0]];
        int64_t first_c = c0;
        if (vertex_seam[v]) {
            // seam-aware swing-left until a seam/boundary stops the walk
            int64_t curr = first_c;
            for (;;) {
                const int64_t nc = next_c(curr);
                if (edge_seam[nc]) { break; }
                const int64_t o = opposite[nc];
                if (o == NONE) { break; }
                curr = next_c(o);
                if (curr == c0) return -1;  // closed loop on a seam vertex
                first_c = curr;
            }
        }
        corner_to_vertex[first_c] = first_vert_id;
        left_most_out[first_vert_id] = first_c;
        int64_t curr = nav.swing_right(first_c);  // universal swing
        while (curr != NONE && curr != first_c) {
            if (edge_seam[next_c(curr)]) {
                first_vert_id = num_new++;
                if (has_v2a)
                    v2a_out[first_vert_id] = att_unique_of_point[points[curr]];
                left_most_out[first_vert_id] = curr;
            }
            corner_to_vertex[curr] = first_vert_id;
            curr = nav.swing_right(curr);
        }
    }
    return num_new;
}

// Sequential UV decode chain (decoder-side TexCoordPrediction +
// wrapped-difference inverse; shared/attribute/prediction.py predict and
// reference mesh_prediction_for_texture_coordinates.rs). The decoder's UV
// prediction reads previously *decoded* values, so the chain is inherently
// sequential; intermediates use __int128 to match the Python path's
// arbitrary-precision ints under the reference's i64-overflow guards.
static int64_t isqrt_u64(uint64_t value) {
    if (value == 0) return 0;
    uint64_t act = value;
    unsigned __int128 sqrt = 1;
    while (act >= 2) { sqrt <<= 1; act >>= 2; }
    sqrt = (sqrt + value / (uint64_t)sqrt) >> 1;
    while (sqrt * sqrt > (unsigned __int128)value)
        sqrt = (sqrt + value / (uint64_t)sqrt) >> 1;
    return (int64_t)sqrt;
}

static inline int64_t wrap_i32(__int128 v) {
    return (int64_t)((((v % ((__int128)1 << 32)) + ((__int128)1 << 32)
                      + ((__int128)1 << 31)) % ((__int128)1 << 32))
                     - ((__int128)1 << 31));
}

int32_t tdn_decode_texcoords(
        const int64_t* opposite, const int64_t* ctv, const int64_t* lm,
        const int64_t* seq, int64_t T, const uint64_t* corr,
        const uint8_t* orientations, int64_t n_orient,
        const int64_t* pos_by_corner, int64_t num_pos_corners,
        int64_t vmin, int64_t vmax, int64_t V, int64_t* out) {
    (void)opposite; (void)lm;
    std::vector<uint8_t> visited(V, 0);
    int64_t last_v = -2;
    int64_t oi = 0;
    const int64_t max_diff = 1 + vmax - vmin;
    const int64_t i64max = INT64_MAX;

    auto unzig = [](uint64_t u) -> int64_t {
        return (u & 1) ? -(int64_t)(u >> 1) - 1 : (int64_t)(u >> 1);
    };

    for (int64_t k = 0; k < T; ++k) {
        const int64_t c = seq[k];
        const int64_t nc = next_c(c), pc = prev_c(c);
        const int64_t van = ctv[nc], vap = ctv[pc];
        int64_t pred[2] = {0, 0};
        bool have = false;

        if (van >= 0 && vap >= 0 && visited[van] && visited[vap]) {
            const int64_t* next_uv = &out[2 * van];
            const int64_t* prev_uv = &out[2 * vap];
            if (next_uv[0] == prev_uv[0] && next_uv[1] == prev_uv[1]) {
                pred[0] = prev_uv[0]; pred[1] = prev_uv[1];
                have = true;
            } else {
                int64_t cpos[3] = {0, 0, 0}, npos[3] = {0, 0, 0},
                        ppos[3] = {0, 0, 0};
                if (c < num_pos_corners)
                    for (int i = 0; i < 3; ++i) cpos[i] = pos_by_corner[3 * c + i];
                if (nc < num_pos_corners)
                    for (int i = 0; i < 3; ++i) npos[i] = pos_by_corner[3 * nc + i];
                if (pc < num_pos_corners)
                    for (int i = 0; i < 3; ++i) ppos[i] = pos_by_corner[3 * pc + i];
                int64_t pn[3], cn[3];
                __int128 pn_norm2 = 0, cn_dot_pn = 0;
                for (int i = 0; i < 3; ++i) {
                    pn[i] = ppos[i] - npos[i];
                    cn[i] = cpos[i] - npos[i];
                    pn_norm2 += (__int128)pn[i] * pn[i];
                    cn_dot_pn += (__int128)pn[i] * cn[i];
                }
                if (pn_norm2 != 0) {
                    const int64_t pn_uv[2] = {prev_uv[0] - next_uv[0],
                                              prev_uv[1] - next_uv[1]};
                    int64_t n_uv_am = std::max(std::abs(next_uv[0]),
                                               std::abs(next_uv[1]));
                    int64_t pn_uv_am = std::max(std::abs(pn_uv[0]),
                                                std::abs(pn_uv[1]));
                    int64_t pn_am = std::max(
                        {std::abs(pn[0]), std::abs(pn[1]), std::abs(pn[2])});
                    __int128 cdp_abs = cn_dot_pn < 0 ? -cn_dot_pn : cn_dot_pn;
                    bool guarded =
                        (__int128)n_uv_am > (__int128)i64max / pn_norm2
                        || (pn_uv_am
                            && cdp_abs > (__int128)(i64max / pn_uv_am))
                        || (pn_am
                            && cdp_abs > (__int128)(i64max / pn_am));
                    if (!guarded) {
                        __int128 x_uv[2], x_pos[3], cx[3];
                        for (int i = 0; i < 2; ++i)
                            x_uv[i] = (__int128)next_uv[i] * pn_norm2
                                      + (__int128)pn_uv[i] * cn_dot_pn;
                        __int128 cx_norm2 = 0;
                        for (int i = 0; i < 3; ++i) {
                            __int128 num = (__int128)pn[i] * cn_dot_pn;
                            __int128 q = num / pn_norm2;  // trunc toward 0
                            x_pos[i] = (__int128)npos[i] + q;
                            cx[i] = (__int128)cpos[i] - x_pos[i];
                            cx_norm2 += cx[i] * cx[i];
                        }
                        uint64_t val = (uint64_t)(
                            (unsigned __int128)(cx_norm2 * pn_norm2));
                        int64_t norm_sq = isqrt_u64(val);
                        __int128 cx_uv0 = (__int128)pn_uv[1] * norm_sq;
                        __int128 cx_uv1 = (__int128)(-pn_uv[0]) * norm_sq;
                        __int128 p0[2] = {(x_uv[0] + cx_uv0) / pn_norm2,
                                          (x_uv[1] + cx_uv1) / pn_norm2};
                        __int128 p1[2] = {(x_uv[0] - cx_uv0) / pn_norm2,
                                          (x_uv[1] - cx_uv1) / pn_norm2};
                        if (oi >= n_orient) return -1;
                        const bool o = orientations[oi++] != 0;
                        pred[0] = wrap_i32(o ? p0[0] : p1[0]);
                        pred[1] = wrap_i32(o ? p0[1] : p1[1]);
                        have = true;
                    }
                }
            }
        }
        if (!have) {
            if (van >= 0 && visited[van]) {
                pred[0] = out[2 * van]; pred[1] = out[2 * van + 1];
            } else if (last_v >= 0) {
                pred[0] = out[2 * last_v]; pred[1] = out[2 * last_v + 1];
            }  // else zeros (first step)
        }

        // inverse wrapped difference (decode/attribute.py inv)
        const int64_t v = ctv[c];
        if (v < 0 || v >= V) return -1;
        for (int i = 0; i < 2; ++i) {
            int64_t pc_ = std::min(std::max(pred[i], vmin), vmax);
            int64_t t = pc_ + unzig(corr[2 * k + i]);
            if (t > vmax) t -= max_diff;
            else if (t < vmin) t += max_diff;
            out[2 * v + i] = t;
        }
        visited[v] = 1;
        last_v = v;
    }
    return 0;
}

// Bulk CrLight CLERS decode, LSB-first (shared/clers.py crlight_decode).
// Returns 0 or -1 on bitstream underrun.
int32_t tdn_crlight_decode(const uint8_t* bytes, int64_t nbytes,
                            int64_t num_symbols, int32_t* out) {
    int64_t bitpos = 0;
    const int64_t nbits = nbytes * 8;
    for (int64_t i = 0; i < num_symbols; ++i) {
        if (bitpos >= nbits) return -1;
        int b = (bytes[bitpos >> 3] >> (bitpos & 7)) & 1;
        ++bitpos;
        if (b == 0) { out[i] = 0; continue; }  // C
        if (bitpos + 2 > nbits) return -1;
        int b1 = (bytes[bitpos >> 3] >> (bitpos & 7)) & 1;
        ++bitpos;
        int b2 = (bytes[bitpos >> 3] >> (bitpos & 7)) & 1;
        ++bitpos;
        static const int32_t map4[4] = {1, 2, 3, 4};  // S, L, R, E
        out[i] = map4[b1 | (b2 << 1)];
    }
    return 0;
}

}  // extern "C" (reopened below; the spirale core is a C++ static)

// Spirale Reversi reconstruction core, exact port of
// shared/spirale.py spirale_reversi_core. Outputs are pre-sized by the
// caller: opposite/ctv of 3*num_faces filled with NONE, left_most of
// num_vertices+num_split_symbols filled with NONE.
//
// Symbol acquisition, per mode:
//   - standard:        symbols[sid] (pre-decoded CLERS)
//   - valence decode:  queues = per-context symbol arrays (bounds
//                      queue_off[ctx]..queue_off[ctx+1]); the context is
//                      the clamped current valence of the attach vertex
//                      (shared/spirale.py valence_context)
//   - valence encode:  symbols[sid] + ctx_out records the context per sid
//                      (the encoder's decoder-simulation)
// Returns num_decoded_faces, or -1 on any malformed-stream condition (the
// caller re-runs the Python core for the detailed error).
static int64_t spirale_core(
        const int32_t* symbols, const int32_t* queues,
        const int64_t* queue_off, int32_t* ctx_out,
        int64_t num_symbols, int64_t num_split_symbols,
        int64_t num_vertices, int64_t num_faces,
        const int64_t* split_merge, const int64_t* split_split,
        const int64_t* split_orient, int64_t n_splits,
        int64_t* opposite, int64_t* ctv, int64_t* left_most,
        int64_t* out_num_vertices,
        int64_t* active_stack_out, int64_t* out_stack_len,
        int64_t* invalid_out, int64_t* out_invalid_len) {
    const int64_t max_nv = num_vertices + num_split_symbols;
    const bool valence = queues != nullptr || ctx_out != nullptr;
    Nav nav{opposite};
    int64_t qpos[8];
    if (queues)
        for (int i = 0; i < 6; ++i) qpos[i] = queue_off[i];
    int64_t nv = 0;
    std::vector<int64_t> stack;
    stack.reserve(64);
    std::vector<int64_t> split_active(num_symbols, NONE);
    int64_t n_invalid = 0;
    int64_t split_i = n_splits - 1;  // consumed from the back
    int64_t faces = 0;

    auto swing_left = [&](int64_t c) -> int64_t {
        int64_t o = opposite[next_c(c)];
        return o != NONE ? next_c(o) : NONE;
    };

    for (int64_t sid = 0; sid < num_symbols; ++sid) {
        if (faces >= num_faces) return -1;
        const int64_t corner = 3 * (faces++);
        int32_t symbol;
        if (valence) {
            int ctx = 0;
            if (!stack.empty()) {
                const int64_t v = ctv[next_c(stack.back())];
                int64_t n = 0;
                if (v >= 0 && v < max_nv) {
                    const int64_t start = left_most[v];
                    int64_t cc = start;
                    // bounded like the S-walk: corrupt opposites can
                    // cycle without revisiting start
                    while (cc != NONE && n <= 3 * num_faces) {
                        ++n;
                        cc = nav.swing_right(cc);
                        if (cc == start) break;
                    }
                }
                ctx = (int)(n < 2 ? 2 : (n > 7 ? 7 : n)) - 2;
            }
            if (queues) {
                if (qpos[ctx] >= queue_off[ctx + 1]) return -1;
                symbol = queues[qpos[ctx]++];
            } else {
                symbol = symbols[sid];
            }
            if (ctx_out) ctx_out[sid] = ctx;
        } else {
            symbol = symbols[sid];
        }
        bool check_split = false;
        if (symbol == 0) {  // C
            if (stack.empty()) return -1;
            const int64_t corner_a = stack.back();
            const int64_t vertex_x = ctv[next_c(corner_a)];
            if (vertex_x < 0 || vertex_x >= max_nv
                || left_most[vertex_x] < 0) return -1;
            const int64_t corner_b = next_c(left_most[vertex_x]);
            if (corner_a == corner_b) return -1;
            opposite[corner_a] = corner + 1; opposite[corner + 1] = corner_a;
            opposite[corner_b] = corner + 2; opposite[corner + 2] = corner_b;
            if (corner_b < 0 || corner_b >= 3 * num_faces) return -1;
            const int64_t vert_a_prev = ctv[prev_c(corner_a)];
            const int64_t vert_b_next = ctv[next_c(corner_b)];
            if (vertex_x == vert_a_prev || vertex_x == vert_b_next) return -1;
            if (vert_a_prev < 0 || vert_a_prev >= max_nv) return -1;
            ctv[corner] = vertex_x;
            ctv[corner + 1] = vert_b_next;
            ctv[corner + 2] = vert_a_prev;
            left_most[vert_a_prev] = corner + 2;
            stack.back() = corner;
        } else if (symbol == 3 || symbol == 2) {  // R / L
            if (stack.empty()) return -1;
            const int64_t corner_a = stack.back();
            int64_t opp_corner, corner_l, corner_r;
            if (symbol == 3) {  // R
                opp_corner = corner + 2; corner_l = corner + 1; corner_r = corner;
            } else {
                opp_corner = corner + 1; corner_l = corner; corner_r = corner + 2;
            }
            opposite[opp_corner] = corner_a; opposite[corner_a] = opp_corner;
            if (nv >= max_nv) return -1;
            const int64_t new_vert = nv++;
            ctv[opp_corner] = new_vert;
            left_most[new_vert] = opp_corner;
            const int64_t vertex_r = ctv[prev_c(corner_a)];
            if (vertex_r < 0 || vertex_r >= max_nv) return -1;
            ctv[corner_r] = vertex_r;
            left_most[vertex_r] = corner_r;
            ctv[corner_l] = ctv[next_c(corner_a)];
            stack.back() = corner;
            check_split = true;
        } else if (symbol == 1) {  // S
            if (stack.empty()) return -1;
            const int64_t corner_b = stack.back();
            stack.pop_back();
            if (split_active[sid] != NONE) {
                stack.push_back(split_active[sid]);
            }
            if (stack.empty()) return -1;
            const int64_t corner_a = stack.back();
            if (corner_a == corner_b) return -1;
            opposite[corner_a] = corner + 2; opposite[corner + 2] = corner_a;
            opposite[corner_b] = corner + 1; opposite[corner + 1] = corner_b;
            const int64_t vertex_p = ctv[prev_c(corner_a)];
            if (vertex_p < 0 || vertex_p >= max_nv) return -1;
            ctv[corner] = vertex_p;
            ctv[corner + 1] = ctv[next_c(corner_a)];
            const int64_t vert_b_prev = ctv[prev_c(corner_b)];
            if (vert_b_prev < 0 || vert_b_prev >= max_nv) return -1;
            ctv[corner + 2] = vert_b_prev;
            left_most[vert_b_prev] = corner + 2;
            int64_t corner_n = next_c(corner_b);
            const int64_t vertex_n = ctv[corner_n];
            if (vertex_n < 0 || vertex_n >= max_nv) return -1;
            left_most[vertex_p] = left_most[vertex_n];
            const int64_t first_cn = corner_n;
            // bounded: a corrupt stream can wire an opposite cycle that
            // never revisits first_cn (soak-found round 3)
            int64_t walk_steps = 0;
            while (corner_n != NONE) {
                ctv[corner_n] = vertex_p;
                corner_n = swing_left(corner_n);
                if (corner_n == first_cn || ++walk_steps > 3 * num_faces)
                    return -1;
            }
            left_most[vertex_n] = NONE;  // isolated
            invalid_out[n_invalid++] = vertex_n;
            stack.back() = corner;
        } else if (symbol == 4) {  // E
            if (nv + 3 > max_nv) return -1;
            const int64_t v0 = nv++, v1 = nv++, v2 = nv++;
            ctv[corner] = v0; ctv[corner + 1] = v1; ctv[corner + 2] = v2;
            left_most[v0] = corner;
            left_most[v1] = corner + 1;
            left_most[v2] = corner + 2;
            stack.push_back(corner);
            check_split = true;
        } else {
            return -1;
        }

        if (check_split) {
            const int64_t encoder_symbol_id = num_symbols - sid - 1;
            while (split_i >= 0 && split_merge[split_i] == encoder_symbol_id) {
                const int64_t enc_split_id = split_split[split_i];
                const int64_t orient = split_orient[split_i];
                --split_i;
                if (stack.empty()) return -1;
                const int64_t act_top = stack.back();
                const int64_t new_active =
                    orient == 1 ? next_c(act_top) : prev_c(act_top);
                const int64_t dec_split_id = num_symbols - enc_split_id - 1;
                if (dec_split_id < 0 || dec_split_id >= num_symbols) return -1;
                split_active[dec_split_id] = new_active;
            }
        }
    }
    *out_num_vertices = nv;
    *out_stack_len = (int64_t)stack.size();
    for (size_t i = 0; i < stack.size(); ++i) active_stack_out[i] = stack[i];
    *out_invalid_len = n_invalid;
    return faces;
}

extern "C" {

int64_t tdn_spirale(const int32_t* symbols, int64_t num_symbols,
                     int64_t num_split_symbols, int64_t num_vertices,
                     int64_t num_faces,
                     const int64_t* split_merge, const int64_t* split_split,
                     const int64_t* split_orient, int64_t n_splits,
                     int64_t* opposite, int64_t* ctv, int64_t* left_most,
                     int64_t* out_num_vertices,
                     int64_t* active_stack_out, int64_t* out_stack_len,
                     int64_t* invalid_out, int64_t* out_invalid_len) {
    return spirale_core(symbols, nullptr, nullptr, nullptr, num_symbols,
                        num_split_symbols, num_vertices, num_faces,
                        split_merge, split_split, split_orient, n_splits,
                        opposite, ctv, left_most, out_num_vertices,
                        active_stack_out, out_stack_len, invalid_out,
                        out_invalid_len);
}

// Valence decode: symbols pulled from per-context queues.
int64_t tdn_spirale_valence(
        const int32_t* queues, const int64_t* queue_off,
        int64_t num_symbols, int64_t num_split_symbols,
        int64_t num_vertices, int64_t num_faces,
        const int64_t* split_merge, const int64_t* split_split,
        const int64_t* split_orient, int64_t n_splits,
        int64_t* opposite, int64_t* ctv, int64_t* left_most,
        int64_t* out_num_vertices,
        int64_t* active_stack_out, int64_t* out_stack_len,
        int64_t* invalid_out, int64_t* out_invalid_len) {
    return spirale_core(nullptr, queues, queue_off, nullptr, num_symbols,
                        num_split_symbols, num_vertices, num_faces,
                        split_merge, split_split, split_orient, n_splits,
                        opposite, ctv, left_most, out_num_vertices,
                        active_stack_out, out_stack_len, invalid_out,
                        out_invalid_len);
}

// Valence encode simulation: symbols known (decode order); outputs the
// per-symbol context assignment.
int64_t tdn_spirale_contexts(
        const int32_t* symbols, int32_t* ctx_out,
        int64_t num_symbols, int64_t num_split_symbols,
        int64_t num_vertices, int64_t num_faces,
        const int64_t* split_merge, const int64_t* split_split,
        const int64_t* split_orient, int64_t n_splits,
        int64_t* opposite, int64_t* ctv, int64_t* left_most,
        int64_t* out_num_vertices,
        int64_t* active_stack_out, int64_t* out_stack_len,
        int64_t* invalid_out, int64_t* out_invalid_len) {
    return spirale_core(symbols, nullptr, nullptr, ctx_out, num_symbols,
                        num_split_symbols, num_vertices, num_faces,
                        split_merge, split_split, split_orient, n_splits,
                        opposite, ctv, left_most, out_num_vertices,
                        active_stack_out, out_stack_len, invalid_out,
                        out_invalid_len);
}

}  // extern "C"
