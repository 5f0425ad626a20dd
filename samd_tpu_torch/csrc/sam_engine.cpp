// Native suffix-automaton engine for SAM-Decoding (host side).  A copy of
// the reference package's csrc/sam_engine.cpp, built by
// samd_tpu_torch/sam/native.py with g++.
//
// Semantics mirror samd_tpu_torch/sam/automaton.py exactly (parity-tested
// in tests/test_torch_sam.py); see that module for the algorithm notes and
// reference citations.  This implementation exists because the per-token
// construction/match walks are the host-side serial bottleneck of the decode
// loop (reference does them in pure Python dicts,
// samd/sam/dyn_sam.py:84-92) and corpus builds index 10^8+
// tokens.
//
// Layout: structure-of-arrays states; per-state transitions as small sorted
// (token, dst) vectors — O(log d) lookup, cache-friendly, and trivially
// exportable to the CSR serialization format (samd_tpu_torch/sam/serialize.py).
//
// C ABI (extern "C") for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int32_t ROOT = 0;
constexpr int32_t NO_LINK = -1;

struct Edge {
  int32_t token;
  int32_t dst;
};

struct Sam {
  // state arrays
  std::vector<std::vector<Edge>> trans;
  std::vector<int32_t> link;
  std::vector<int32_t> len;
  std::vector<int32_t> first_end;
  std::vector<int64_t> occ;
  int32_t last = ROOT;
  bool track_text = true;
  bool track_counts = false;
  std::vector<int32_t> text;
  // cursor
  int32_t cur_state = ROOT;
  int32_t cur_length = 0;
  // top-k tables (built by finalize_topk)
  int32_t topk_k = 0;
  std::vector<std::vector<Edge>> topk;

  Sam(bool tt, bool tc) : track_text(tt), track_counts(tc) {
    trans.emplace_back();
    link.push_back(NO_LINK);
    len.push_back(0);
    first_end.push_back(NO_LINK);
    occ.push_back(0);
  }

  int32_t find(int32_t s, int32_t token) const {
    const auto& v = trans[s];
    auto it = std::lower_bound(
        v.begin(), v.end(), token,
        [](const Edge& e, int32_t t) { return e.token < t; });
    if (it != v.end() && it->token == token) return it->dst;
    return NO_LINK;
  }

  void put(int32_t s, int32_t token, int32_t dst) {
    auto& v = trans[s];
    auto it = std::lower_bound(
        v.begin(), v.end(), token,
        [](const Edge& e, int32_t t) { return e.token < t; });
    if (it != v.end() && it->token == token) {
      it->dst = dst;
    } else {
      v.insert(it, Edge{token, dst});
    }
  }

  int32_t new_state(int32_t length, int32_t lnk, int32_t fe, int64_t oc) {
    trans.emplace_back();
    link.push_back(lnk);
    len.push_back(length);
    first_end.push_back(fe);
    occ.push_back(oc);
    return static_cast<int32_t>(link.size()) - 1;
  }

  void extend(int32_t token) {
    int32_t pos = static_cast<int32_t>(text.size());
    text.push_back(track_text ? token : 0);
    int32_t cur = new_state(pos + 1, NO_LINK, pos, 0);
    int32_t p = last;
    while (p != NO_LINK && find(p, token) == NO_LINK) {
      put(p, token, cur);
      p = link[p];
    }
    if (p == NO_LINK) {
      link[cur] = ROOT;
    } else {
      int32_t q = find(p, token);
      if (len[p] + 1 == len[q]) {
        link[cur] = q;
      } else {
        // clone q (inherits transitions, first_end and occurrence count)
        int32_t clone = new_state(len[p] + 1, link[q], first_end[q], occ[q]);
        trans[clone] = trans[q];
        while (p != NO_LINK && find(p, token) == q) {
          put(p, token, clone);
          p = link[p];
        }
        link[q] = clone;
        link[cur] = clone;
      }
    }
    last = cur;
    if (track_counts) {
      for (int32_t s = cur; s != ROOT; s = link[s]) occ[s] += 1;
    }
  }

  void match_step(int32_t& state, int32_t& length, int32_t token) const {
    while (state != ROOT && find(state, token) == NO_LINK) {
      state = link[state];
      length = len[state];
    }
    int32_t nxt = find(state, token);
    if (nxt == NO_LINK) {
      state = ROOT;
      length = 0;
    } else {
      state = nxt;
      length += 1;
    }
  }
};

}  // namespace

extern "C" {

Sam* sam_create(int track_text, int track_counts) {
  return new Sam(track_text != 0, track_counts != 0);
}

void sam_destroy(Sam* s) { delete s; }

int64_t sam_num_states(const Sam* s) { return (int64_t)s->link.size(); }

int64_t sam_text_len(const Sam* s) { return (int64_t)s->text.size(); }

int64_t sam_num_edges(const Sam* s) {
  int64_t n = 0;
  for (const auto& v : s->trans) n += (int64_t)v.size();
  return n;
}

// feed tokens: grow != 0 -> advance cursor + index (add_tokens);
// grow == 0 -> cursor only (transfer_tokens)
void sam_feed(Sam* s, const int32_t* tokens, int64_t n, int grow) {
  for (int64_t i = 0; i < n; ++i) {
    s->match_step(s->cur_state, s->cur_length, tokens[i]);
    if (grow) s->extend(tokens[i]);
  }
}

// index one token without moving the cursor (the Python engine's extend)
void sam_extend(Sam* s, int32_t token) { s->extend(token); }

void sam_reset_cursor(Sam* s) {
  s->cur_state = ROOT;
  s->cur_length = 0;
}

void sam_reset(Sam* s) {
  Sam fresh(s->track_text, s->track_counts);
  *s = std::move(fresh);
}

void sam_cursor(const Sam* s, int32_t* out_state, int32_t* out_length) {
  *out_state = s->cur_state;
  *out_length = s->cur_length;
}

void sam_peek(const Sam* s, int32_t token, int32_t* out_state,
              int32_t* out_length) {
  int32_t st = s->cur_state, ln = s->cur_length;
  s->match_step(st, ln, token);
  *out_state = st;
  *out_length = ln;
}

// Stateless cursor walk (for shared automata with per-request cursors):
// advances (state, length) over n tokens without touching internal state.
void sam_match(const Sam* s, int32_t state, int32_t length,
               const int32_t* tokens, int64_t n, int32_t* out_state,
               int32_t* out_length) {
  for (int64_t i = 0; i < n; ++i) s->match_step(state, length, tokens[i]);
  *out_state = state;
  *out_length = length;
}

// Sequence draft: [start_token] + continuation after the state's first
// occurrence; optional suffix-link widening and zero-padding (hybrid mode).
// Returns the number of tokens written (<= n_predicts).
int32_t sam_sequence_draft(const Sam* s, int32_t state, int32_t start_token,
                           int32_t n_predicts, int widen, int pad,
                           int32_t* out) {
  if (widen && state != ROOT) {
    int32_t remaining =
        (int32_t)s->text.size() - 1 - s->first_end[state];
    while (s->link[state] != ROOT && remaining < n_predicts) {
      state = s->link[state];
      remaining = (int32_t)s->text.size() - 1 - s->first_end[state];
    }
  }
  int32_t count = 0;
  out[count++] = start_token;
  int64_t start = (int64_t)s->first_end[state] + 1;
  int64_t end = std::min<int64_t>(start + n_predicts - 1,
                                  (int64_t)s->text.size());
  for (int64_t i = start; i < end && count < n_predicts; ++i)
    out[count++] = s->text[i];
  if (pad) {
    while (count < n_predicts) out[count++] = 0;
  }
  return count;
}

void sam_finalize_topk(Sam* s, int32_t k) {
  s->topk_k = k;
  s->topk.assign(s->trans.size(), {});
  for (size_t i = 0; i < s->trans.size(); ++i) {
    auto v = s->trans[i];  // copy
    std::stable_sort(v.begin(), v.end(), [&](const Edge& a, const Edge& b) {
      return s->occ[a.dst] > s->occ[b.dst];
    });
    if ((int32_t)v.size() > k) v.resize(k);
    s->topk[i] = std::move(v);
  }
}

// Frequency-tree draft: best-first expansion by path probability
// (occ(child)/occ(parent)), at most k nodes per depth, n_nodes total.
// Writes node tokens and parent indices; returns the node count.
int32_t sam_tree_draft(Sam* s, int32_t state, int32_t start_token,
                       int32_t n_nodes, int32_t k, int32_t* out_tokens,
                       int32_t* out_parents) {
  if (s->topk_k < k || s->topk.empty()) sam_finalize_topk(s, k);
  struct Item {
    double prob;
    int64_t order;  // insertion tiebreak (matches Python heap behavior)
    int32_t token, state, parent, depth;
  };
  auto cmp = [](const Item& a, const Item& b) {
    if (a.prob != b.prob) return a.prob < b.prob;  // max-heap by prob
    return a.order > b.order;                      // FIFO among ties
  };
  std::priority_queue<Item, std::vector<Item>, decltype(cmp)> heap(cmp);
  std::vector<int32_t> depth_used;
  int64_t order = 0;
  heap.push(Item{1.0, order++, start_token, state, -1, 0});
  int32_t count = 0;
  while (count < n_nodes && !heap.empty()) {
    Item it = heap.top();
    heap.pop();
    if ((int32_t)depth_used.size() <= it.depth) depth_used.resize(it.depth + 1, 0);
    if (depth_used[it.depth] >= k) continue;
    depth_used[it.depth] += 1;
    int32_t node = count;
    out_tokens[count] = it.token;
    out_parents[count] = it.parent;
    ++count;
    if (count == n_nodes) break;
    int64_t denom = s->occ[it.state] > 0 ? s->occ[it.state] : 1;
    const auto& children = s->topk[it.state];
    int32_t limit = std::min<int32_t>((int32_t)children.size(), k);
    for (int32_t j = 0; j < limit; ++j) {
      double p = it.prob * ((double)s->occ[children[j].dst] / (double)denom);
      heap.push(Item{p, order++, children[j].token, children[j].dst, node,
                     it.depth + 1});
    }
  }
  return count;
}

// ---- CSR export/import (matches samd_tpu/sam/serialize.py layout) ----

void sam_export(const Sam* s, int32_t* link, int32_t* length,
                int32_t* first_end, int64_t* occ, int64_t* trans_ptr,
                int32_t* trans_tok, int32_t* trans_dst, int32_t* text) {
  int64_t n = (int64_t)s->link.size();
  std::memcpy(link, s->link.data(), n * sizeof(int32_t));
  std::memcpy(length, s->len.data(), n * sizeof(int32_t));
  std::memcpy(first_end, s->first_end.data(), n * sizeof(int32_t));
  std::memcpy(occ, s->occ.data(), n * sizeof(int64_t));
  int64_t e = 0;
  for (int64_t i = 0; i < n; ++i) {
    trans_ptr[i] = e;
    for (const Edge& ed : s->trans[i]) {  // already token-sorted
      trans_tok[e] = ed.token;
      trans_dst[e] = ed.dst;
      ++e;
    }
  }
  trans_ptr[n] = e;
  std::memcpy(text, s->text.data(), s->text.size() * sizeof(int32_t));
}

void sam_import(Sam* s, int64_t n_states, int64_t n_edges, int64_t text_len,
                const int32_t* link, const int32_t* length,
                const int32_t* first_end, const int64_t* occ,
                const int64_t* trans_ptr, const int32_t* trans_tok,
                const int32_t* trans_dst, const int32_t* text) {
  s->trans.assign(n_states, {});
  s->link.assign(link, link + n_states);
  s->len.assign(length, length + n_states);
  s->first_end.assign(first_end, first_end + n_states);
  s->occ.assign(occ, occ + n_states);
  for (int64_t i = 0; i < n_states; ++i) {
    int64_t b = trans_ptr[i], e = trans_ptr[i + 1];
    s->trans[i].reserve(e - b);
    for (int64_t j = b; j < e; ++j)
      s->trans[i].push_back(Edge{trans_tok[j], trans_dst[j]});
  }
  s->text.assign(text, text + text_len);
  // `last` = state of the full text (only needed to keep growing)
  s->last = ROOT;
  for (int64_t i = 0; i < n_states; ++i) {
    if (s->len[i] == (int32_t)text_len && s->first_end[i] == (int32_t)text_len - 1) {
      s->last = (int32_t)i;
      break;
    }
  }
  s->cur_state = ROOT;
  s->cur_length = 0;
  (void)n_edges;
}

}  // extern "C"
