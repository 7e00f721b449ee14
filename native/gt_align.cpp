// Native batch read-to-graph aligner for graphtyper_tpu.
//
// Ports the host alignment pipeline (graphtyper_tpu/typer/alignment.py,
// genotype_paths.py, path.py, graph/dfs.py — themselves re-implementations of
// the reference's src/typer/alignment.cpp seeding, genotype_paths.cpp lattice
// merge, and graph.cpp:1187-1760 bounded walk enumeration) to C++ operating
// directly on the flat graph/index arrays, processing a whole batch of reads
// per call. Bit-identical to the Python path (tests/typer/test_native_align.py
// asserts path-level parity); the Python implementation remains the oracle.
//
// Exposed as a C ABI for ctypes: gt_align_batch -> sizes + opaque handle,
// gt_align_fetch -> flat result arrays, gt_align_free.

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// --- optional stage profiling (GT_NATIVE_PROFILE=1): relaxed atomics, ns ---
inline bool prof_enabled()
{
  static const bool on = []() {
    const char * e = std::getenv("GT_NATIVE_PROFILE");
    return e && *e && *e != '0';
  }();
  return on;
}
inline int64_t prof_now()
{
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
           std::chrono::steady_clock::now().time_since_epoch())
    .count();
}
std::atomic<int64_t> prof_seed_ns{0}, prof_lattice_ns{0}, prof_walk_ns{0};

constexpr int K = 32;
constexpr int64_t SPECIAL_START = 0xD0000000LL;
constexpr int64_t INVALID_ID = 0xFFFFFFFFLL;
constexpr int MAX_VAR_AND_REFS = 128;
constexpr int MAX_LOCATIONS = 1024;
constexpr int MAX_UNIQUE_KMER_POSITIONS = 512;
// ph_index.cpp:49-57 / options.hpp max_index_labels: multi-key lookups give
// up on a kmer past this many labels
constexpr int MAX_INDEX_LABELS = 75;
constexpr int MAX_SEED_NUMBER_FOR_WALKING = 256;
constexpr int MAX_SEED_NUMBER_ALLOWING_MISMATCHES = 64;
constexpr int MAX_NUM_LOCATIONS_PER_PATH = 256;
constexpr uint8_t TAG_CODE = 6;

constexpr uint32_t IS_PAIRED = 0x1;

// IUPAC base sets per code (utils/dna.py IUPAC_SETS_BY_CODE): codes 0..14
static const uint8_t IUPAC_SETS[15][5] = {
  // {count, members...} in A<C<G<T order
  {1, 0}, {1, 1}, {1, 2}, {1, 3},
  {4, 0, 1, 2, 3},              // N
  {2, 0, 2}, {2, 1, 3}, {2, 1, 2}, {2, 0, 3}, {2, 2, 3}, {2, 0, 1},  // RYSWKM
  {3, 1, 2, 3}, {3, 0, 2, 3}, {3, 0, 1, 3}, {3, 0, 1, 2},            // BDHV
};

// code-level reverse complement (utils/dna.py _CODE_COMPLEMENT)
static const uint8_t CODE_COMP[16] = {3, 2, 1, 0, 4, 6, 5, 7, 8, 10, 9, 14, 13, 12, 11, 15};

struct GraphView {
  const int64_t * ref_order;
  const int64_t * ref_dna_start;
  const int64_t * ref_dna_len;
  const int64_t * ref_var_first;  // [n_ref + 1]
  int64_t n_ref;
  const uint8_t * ref_arena;
  const int64_t * var_order;
  const int64_t * var_dna_start;
  const int64_t * var_dna_len;
  const int64_t * var_out_ref;
  int64_t n_var;
  const uint8_t * var_arena;
  const int64_t * sp_ref_reach;  // sorted (runs per multi-degree ref node)
  const int64_t * sp_actual;
  int64_t n_special;
  bool is_sv;

  int64_t out_deg(int64_t r) const { return ref_var_first[r + 1] - ref_var_first[r]; }
  int64_t ref_reach(int64_t r) const { return ref_order[r] + ref_dna_len[r] - 1; }
  int64_t var_reach(int64_t v) const { return var_order[v] + var_dna_len[v] - 1; }
  const uint8_t * ref_dna(int64_t r) const { return ref_arena + ref_dna_start[r]; }
  const uint8_t * var_dna(int64_t v) const { return var_arena + var_dna_start[v]; }

  bool is_special(int64_t pos) const
  {
    return pos >= SPECIAL_START && (pos - SPECIAL_START) < n_special;
  }

  int64_t get_ref_reach_pos(int64_t pos) const
  {
    return is_special(pos) ? sp_ref_reach[pos - SPECIAL_START] : pos;
  }

  int64_t get_actual_pos(int64_t pos) const
  {
    return is_special(pos) ? sp_actual[pos - SPECIAL_START] : pos;
  }

  // graph.get_special_pos(pos, ref_reach): index into the contiguous run of
  // special positions sharing this ref_reach
  int64_t get_special_pos(int64_t pos, int64_t rr) const
  {
    const int64_t * first = std::lower_bound(sp_ref_reach, sp_ref_reach + n_special, rr);
    return SPECIAL_START + (first - sp_ref_reach) + (pos - rr - 1);
  }

  int64_t variant_num(int64_t v) const
  {
    return v - ref_var_first[var_out_ref[v] - 1];
  }

  // reach of the reference allele of v's site (dfs.py _site_ref_reach)
  int64_t site_ref_reach(int64_t v) const
  {
    int64_t r = var_out_ref[v] - 1;
    return var_reach(ref_var_first[r]);
  }
};

struct IndexView {
  const uint64_t * keys;
  int64_t n_keys;
  const int64_t * offsets;
  const int64_t * lab_start;
  const int64_t * lab_end;
  const int64_t * lab_var;

  // span for an exact key
  void get(uint64_t key, int64_t & a, int64_t & b) const
  {
    const uint64_t * it = std::lower_bound(keys, keys + n_keys, key);
    if (it == keys + n_keys || *it != key)
    {
      a = b = 0;
      return;
    }
    int64_t i = it - keys;
    a = offsets[i];
    b = offsets[i + 1];
  }
};

struct Label {
  int64_t start, end, var_id;
};

// Seed filter: two membership bitsets over the sorted index keys that gate
// the 97-probe-per-kmer seeding (1 exact + 96 Hamming-1). The reference
// probes a hash map with all 97 keys per kmer (alignment.cpp:30-31 +
// kmer_help_functions.cpp:93-119); here the 96x Hamming expansion is flipped
// from the query side to the BUILD side: `ham` holds a hash of every
// Hamming-1 neighbor of every index key, so a read kmer needs exactly one
// `ham` probe to learn whether ANY of its 96 Hamming-1 probes can hit the
// index (no false negatives by construction; false positives cost one pass
// of 96 `exact`-bitset tests). `exact` gates individual probes before the
// binary search. Net: ~2 L2/L3-local bitset probes per kmer instead of 97
// binary searches, with bit-identical candidates.
struct SeedFilter {
  std::vector<uint32_t> exact, ham;
  int32_t bits_e = 0, bits_h = 0;
  // prefix-bucket accelerator over the SAME sorted key array the filter was
  // built from: bucket[b] = first key index whose top `bucket_bits` equal b.
  // Probes that pass the bitsets then lower_bound over ~4 keys instead of a
  // log2(n_keys)-deep cache-missing binary search.
  std::vector<int64_t> bucket;
  int32_t bucket_bits = 0;

  static inline uint32_t h1(uint64_t k, int32_t bits)
  {
    uint32_t lo = (uint32_t)k, hi = (uint32_t)(k >> 32);
    return (lo * 0x9E3779B1u + hi * 0x85EBCA77u) >> (32 - bits);
  }
  static inline uint32_t h2(uint64_t k, int32_t bits)
  {
    uint32_t lo = (uint32_t)k, hi = (uint32_t)(k >> 32);
    return (lo * 0x85EBCA77u + hi * 0x9E3779B1u) >> (32 - bits);
  }
  inline bool test_exact(uint64_t k) const
  {
    uint32_t h = h1(k, bits_e);
    return (exact[h >> 5] >> (h & 31)) & 1u;
  }
  inline bool test_ham(uint64_t k) const
  {
    uint32_t h = h2(k, bits_h);
    return (ham[h >> 5] >> (h & 31)) & 1u;
  }
};

struct Path {
  int64_t start = 0, end = 0;
  int32_t rsi = 0, rei = 0;  // read start/end index
  int32_t mismatches = 0;
  std::vector<int64_t> var_order;
  std::vector<std::vector<uint16_t>> nums;  // sorted unique allele sets

  int32_t size() const { return rei - rsi + 1; }
  bool is_empty() const { return start == end; }

  bool is_reference() const
  {
    for (auto const & n : nums)
      if (!std::binary_search(n.begin(), n.end(), (uint16_t)0))
        return false;
    return true;
  }
};

static void nums_insert(std::vector<uint16_t> & v, uint16_t x)
{
  auto it = std::lower_bound(v.begin(), v.end(), x);
  if (it == v.end() || *it != x)
    v.insert(it, x);
}

struct Geno {
  std::vector<Path> paths;
  int32_t longest = 0;
  int32_t read_length = 0;

  void update_longest() {
    longest = 0;
    for (auto const & p : paths)
      longest = std::max(longest, p.size());
  }

  void remove_short_paths()
  {
    size_t w = 0;
    for (size_t i = 0; i < paths.size(); ++i)
      if (paths[i].size() >= longest)
      {
        if (w != i)
          paths[w] = std::move(paths[i]);
        ++w;
      }
    paths.resize(w);
  }
};

// ---------------------------------------------------------------------------
// mismatch counting (dfs.py count_mismatches; graph_utils.hpp:7-69 semantics)
// ---------------------------------------------------------------------------

static int count_mm_fwd(const uint8_t * read, int read_len, const uint8_t * seq, int seq_len, int maxm)
{
  int n = std::min(read_len, seq_len);
  for (int i = 0; i < n; ++i)
    if (seq[i] == TAG_CODE)
      return maxm + 1;
  int mm = 0;
  for (int i = 0; i < n; ++i)
  {
    uint8_t a = read[i], b = seq[i];
    mm += (a != b) & (a < 4) & (b < 4);
  }
  return mm;
}

static int count_mm_bwd(const uint8_t * read, int read_len, const uint8_t * seq, int seq_len, int maxm)
{
  int n = std::min(read_len, seq_len);
  const uint8_t * a = read + (read_len - n);
  const uint8_t * b = seq + (seq_len - n);
  for (int i = 0; i < n; ++i)
    if (b[i] == TAG_CODE)
      return maxm + 1;
  int mm = 0;
  for (int i = 0; i < n; ++i)
    mm += (a[i] != b[i]) & (a[i] < 4) & (b[i] < 4);
  return mm;
}

// ---------------------------------------------------------------------------
// kmer packing with IUPAC fork (alignment.py to_uint64_list/_stride_keys)
// ---------------------------------------------------------------------------

static void to_uint64_list(const uint8_t * codes, std::vector<uint64_t> & keys)
{
  keys.assign(1, 0);
  for (int j = 0; j < K; ++j)
  {
    if (keys.size() > 97)
    {
      keys.clear();
      return;
    }
    uint8_t c = codes[j];
    const uint8_t * set = (c < 15) ? IUPAC_SETS[c] : IUPAC_SETS[4];
    int cnt = set[0];
    const uint8_t * members = set + 1;
    if (cnt == 1)
    {
      for (auto & k : keys)
        k = (k << 2) | members[0];
    }
    else
    {
      // existing slot takes the LAST member in place; earlier members appended
      size_t old = keys.size();
      for (size_t idx = 0; idx < old; ++idx)
      {
        uint64_t base = keys[idx] << 2;
        for (int m = 0; m + 1 < cnt; ++m)
          keys.push_back(base | members[m]);
        keys[idx] = base | members[cnt - 1];
      }
      // NOTE: appended keys interleave per slot in Python via a single
      // extend after the loop; replicate that order: Python collects all
      // appended into one list in slot-major, member-minor order, then
      // extends. The loop above appends per slot in member order == same.
    }
  }
}

// ---------------------------------------------------------------------------
// path label grouping + merge (path.py)
// ---------------------------------------------------------------------------

static Path path_from_label(const GraphView & G, const Label & l, int rsi, int rei, int mm)
{
  Path p;
  p.start = l.start;
  p.end = l.end;
  p.rsi = rsi;
  p.rei = rei;
  p.mismatches = mm;
  if (l.var_id != INVALID_ID)
  {
    p.var_order.push_back(G.var_order[l.var_id]);
    p.nums.push_back({(uint16_t)G.variant_num(l.var_id)});
  }
  return p;
}

static void merge_with_current(const GraphView & G, Path & p, int64_t var_id)
{
  if (var_id == INVALID_ID)
    return;
  int64_t order = G.var_order[var_id];
  uint16_t num = (uint16_t)G.variant_num(var_id);
  for (size_t i = 0; i < p.var_order.size(); ++i)
  {
    if (p.var_order[i] == order)
    {
      nums_insert(p.nums[i], num);
      return;
    }
  }
  p.var_order.push_back(order);
  p.nums.push_back({num});
}

static void find_all_nonduplicated_paths(
  const GraphView & G, const std::vector<Label> & labels, int rsi, int rei, int mm,
  std::vector<Path> & out)
{
  out.clear();
  if (labels.empty())
    return;
  out.push_back(path_from_label(G, labels[0], rsi, rei, mm));
  for (size_t i = 1; i < labels.size(); ++i)
  {
    bool found = false;
    for (auto & p : out)
    {
      if (labels[i].start == p.start && labels[i].end == p.end)
      {
        merge_with_current(G, p, labels[i].var_id);
        found = true;
        break;
      }
    }
    if (!found)
      out.push_back(path_from_label(G, labels[i], rsi, rei, mm));
  }
}

// Path(p1, p2) merge (path.py Path.merge): take p2, intersect shared sites,
// union the rest; adopt p1's start. Empty intersection -> failed merge
// (detectable: read_start_index stays p2's).
static Path path_merge(const Path & p1, const Path & p2)
{
  Path np = p2;
  for (size_t i = 0; i < p1.var_order.size(); ++i)
  {
    bool found = false;
    for (size_t j = 0; j < np.var_order.size(); ++j)
    {
      if (p1.var_order[i] == np.var_order[j])
      {
        // intersect sorted vectors
        std::vector<uint16_t> inter;
        std::set_intersection(np.nums[j].begin(), np.nums[j].end(),
                              p1.nums[i].begin(), p1.nums[i].end(),
                              std::back_inserter(inter));
        np.nums[j] = std::move(inter);
        if (np.nums[j].empty())
          return np;  // failed
        found = true;
        break;
      }
    }
    if (!found)
    {
      np.var_order.push_back(p1.var_order[i]);
      np.nums.push_back(p1.nums[i]);
    }
  }
  np.rsi = p1.rsi;
  np.start = p1.start;
  np.mismatches += p1.mismatches;
  return np;
}

// genotype_paths.py add_next_kmer_labels / add_prev_kmer_labels
static void add_next_kmer_labels(const GraphView & G, Geno & g, const std::vector<Label> & labels,
                                 int read_start, int read_end, int mm)
{
  std::vector<Path> pp;
  find_all_nonduplicated_paths(G, labels, read_start, read_end, mm, pp);
  size_t original_size = g.paths.size();
  std::vector<char> matched(pp.size(), 0);
  for (size_t i = 0; i < original_size; ++i)
  {
    if (g.paths[i].rei != read_start)
      continue;
    bool matched_once = false;
    // the original path stays the comparison/merge source even after slot i
    // is replaced on first match (genotype_paths.py binds it before the loop)
    Path original_copy = g.paths[i];
    for (size_t j = 0; j < pp.size(); ++j)
    {
      if (original_copy.end == pp[j].start && original_copy.rei == pp[j].rsi)
      {
        Path np = path_merge(original_copy, pp[j]);
        if (np.start != original_copy.start || np.rsi != original_copy.rsi)
          continue;
        matched[j] = 1;
        if (matched_once)
          g.paths.push_back(std::move(np));
        else
        {
          g.longest = std::max(np.size(), g.longest);
          g.paths[i] = std::move(np);
          matched_once = true;
        }
      }
    }
  }
  for (size_t j = 0; j < pp.size(); ++j)
  {
    if (!matched[j])
    {
      g.longest = std::max(pp[j].size(), g.longest);
      g.paths.push_back(std::move(pp[j]));
    }
  }
}

static void add_prev_kmer_labels(const GraphView & G, Geno & g, const std::vector<Label> & labels,
                                 int read_start, int read_end, int mm)
{
  std::vector<Path> pp;
  find_all_nonduplicated_paths(G, labels, read_start, read_end, mm, pp);
  size_t original_size = g.paths.size();
  std::vector<char> matched(pp.size(), 0);
  for (size_t i = 0; i < original_size; ++i)
  {
    if (g.paths[i].rsi != read_end)
      continue;
    bool matched_once = false;
    Path original_copy = g.paths[i];
    for (size_t j = 0; j < pp.size(); ++j)
    {
      if (pp[j].end == original_copy.start && pp[j].rei == original_copy.rsi)
      {
        Path np = path_merge(pp[j], original_copy);
        if (np.rsi != pp[j].rsi)
          continue;
        matched[j] = 1;
        if (matched_once)
          g.paths.push_back(std::move(np));
        else
        {
          g.longest = std::max(np.size(), g.longest);
          g.paths[i] = std::move(np);
          matched_once = true;
        }
      }
    }
  }
  for (size_t j = 0; j < pp.size(); ++j)
  {
    if (!matched[j])
    {
      g.longest = std::max(pp[j].size(), g.longest);
      g.paths.push_back(std::move(pp[j]));
    }
  }
}

// ---------------------------------------------------------------------------
// locations + bounded walk enumeration (graph/dfs.py)
// ---------------------------------------------------------------------------

struct Location {
  char type = 'U';  // 'R', 'V', 'U'
  int64_t node_index = 0;
  int64_t node_order = 0;
  int64_t offset = 0;

  bool is_unavailable() const { return type == 'U'; }
};

static void get_locations_of_a_position(const GraphView & G, int64_t pos, const Path & path,
                                        std::vector<Location> & locs)
{
  locs.clear();
  bool is_special = G.is_special(pos);
  if (is_special)
    pos = G.get_actual_pos(pos);
  if (G.n_ref == 0 || pos < G.ref_order[0])
    return;
  if (G.n_ref == 1)
  {
    locs.push_back({'R', 0, G.ref_order[0], pos - G.ref_order[0]});
    return;
  }
  // first r in [1, n_ref] with ref_order[r] > pos (n_ref if none): binary
  // search instead of the linear scan — this runs per walked read end and
  // n_ref grows with the region's variant count
  do
  {
    int64_t r =
      std::upper_bound(G.ref_order + 1, G.ref_order + G.n_ref, pos) - G.ref_order;
    int64_t rr = r - 1;
    if (pos < G.ref_order[rr] + G.ref_dna_len[rr])
    {
      if (!is_special)
      {
        locs.push_back({'R', rr, G.ref_order[rr], pos - G.ref_order[rr]});
        break;
      }
      rr -= 1;
    }
    int64_t padding = G.is_sv ? 1000000 : 1000;
    while (rr >= 0 && G.ref_reach(rr) + padding > pos)
    {
      int64_t first = G.ref_var_first[rr];
      int64_t deg = G.out_deg(rr);
      for (int64_t i = 0; i < deg; ++i)
      {
        int64_t v = first + i;
        int64_t vo = G.var_order[v];
        if (vo <= pos && pos <= G.var_reach(v))
        {
          // require the path to overlap this site with allele i allowed
          int64_t j = -1;
          for (size_t q = 0; q < path.var_order.size(); ++q)
            if (path.var_order[q] == vo)
            {
              j = (int64_t)q;
              break;
            }
          if (j < 0)
            continue;
          if (path.is_empty() ||
              ((size_t)j < path.nums.size() &&
               std::binary_search(path.nums[j].begin(), path.nums[j].end(), (uint16_t)i)))
            locs.push_back({'V', v, vo, pos - vo});
        }
      }
      rr -= 1;
    }
  } while (false);
}

// candidate sequence under construction during the walk
struct Cand {
  std::vector<uint8_t> seq;
  std::vector<int64_t> var_ids;
  int64_t pos = 0;  // end_pos (forward) or start_pos (backward)
};

static void append_seq(std::vector<uint8_t> & dst, const uint8_t * src, int64_t n)
{
  dst.insert(dst.end(), src, src + n);
}

static void prepend_seq(std::vector<uint8_t> & dst, const uint8_t * src, int64_t n)
{
  dst.insert(dst.begin(), src, src + n);
}

// graph.cpp:1187-1438 via dfs.py get_labels_forward
static int get_labels_forward(const GraphView & G, const Location & s,
                              const uint8_t * read, int read_len, int max_mm,
                              std::vector<Label> & labels)
{
  labels.clear();
  std::vector<Cand> cands(1);
  std::vector<int64_t> vars;

  if (s.type == 'V')
  {
    int64_t v = s.node_index;
    cands[0].var_ids.push_back(v);
    append_seq(cands[0].seq, G.var_dna(v) + s.offset, G.var_dna_len[v] - s.offset);
    if ((int)cands[0].seq.size() >= read_len)
    {
      int64_t ep = G.var_reach(v) - ((int64_t)cands[0].seq.size() - read_len);
      int64_t rr = G.site_ref_reach(v);
      if (ep > rr)
        ep = G.get_special_pos(ep, rr);
      cands[0].pos = ep;
    }
    else
    {
      int64_t r = G.var_out_ref[v];
      for (int64_t i = 0; i < G.out_deg(r); ++i)
        vars.push_back(G.ref_var_first[r] + i);
      append_seq(cands[0].seq, G.ref_dna(r), G.ref_dna_len[r]);
      cands[0].pos = G.ref_reach(r) - ((int64_t)cands[0].seq.size() - read_len);
    }
  }
  else
  {
    int64_t r = s.node_index;
    for (int64_t i = 0; i < G.out_deg(r); ++i)
      vars.push_back(G.ref_var_first[r] + i);
    append_seq(cands[0].seq, G.ref_dna(r) + s.offset, G.ref_dna_len[r] - s.offset);
    cands[0].pos = G.ref_reach(r) - ((int64_t)cands[0].seq.size() - read_len);
  }

  if (!vars.empty() && (int)cands[0].seq.size() < read_len)
  {
    int64_t r = G.var_out_ref[vars[0]];
    bool all_long_enough = false;
    while (!all_long_enough && (int)cands.size() < MAX_VAR_AND_REFS && !vars.empty())
    {
      all_long_enough = true;
      const uint8_t * ref_codes = G.ref_dna(r);
      int64_t ref_len = G.ref_dna_len[r];
      size_t original_size = cands.size();
      size_t j = 0;
      while (j < original_size)
      {
        if ((int)cands[j].seq.size() >= read_len)
        {
          ++j;
          continue;
        }
        for (size_t i = 0; i + 1 < vars.size(); ++i)
        {
          int64_t v = vars[i];
          Cand nc;
          nc.seq = cands[j].seq;
          append_seq(nc.seq, G.var_dna(v), G.var_dna_len[v]);
          bool variant_is_enough = (int)nc.seq.size() >= read_len;
          if (!variant_is_enough)
            append_seq(nc.seq, ref_codes, ref_len);
          if (count_mm_fwd(read, read_len, nc.seq.data(), nc.seq.size(), max_mm) <= max_mm)
          {
            nc.var_ids = cands[j].var_ids;
            nc.var_ids.push_back(v);
            if ((int)nc.seq.size() < read_len)
              all_long_enough = false;
            if (variant_is_enough)
            {
              int64_t ep = G.var_reach(v) - ((int64_t)nc.seq.size() - read_len);
              int64_t rr = G.site_ref_reach(v);
              if (ep > rr)
                ep = G.get_special_pos(ep, rr);
              nc.pos = ep;
            }
            else
              nc.pos = G.ref_reach(r) - ((int64_t)nc.seq.size() - read_len);
            cands.push_back(std::move(nc));
          }
        }
        // last variant replaces the current candidate in place
        int64_t last_v = vars.back();
        append_seq(cands[j].seq, G.var_dna(last_v), G.var_dna_len[last_v]);
        bool variant_is_enough = (int)cands[j].seq.size() >= read_len;
        if (!variant_is_enough)
          append_seq(cands[j].seq, ref_codes, ref_len);
        if (count_mm_fwd(read, read_len, cands[j].seq.data(), cands[j].seq.size(), max_mm) <= max_mm)
        {
          cands[j].var_ids.push_back(last_v);
          if ((int)cands[j].seq.size() < read_len)
            all_long_enough = false;
          if (variant_is_enough)
          {
            int64_t ep = G.var_reach(last_v) - ((int64_t)cands[j].seq.size() - read_len);
            int64_t rr = G.site_ref_reach(last_v);
            if (ep > rr)
              ep = G.get_special_pos(ep, rr);
            cands[j].pos = ep;
          }
          else
            cands[j].pos = G.ref_reach(r) - ((int64_t)cands[j].seq.size() - read_len);
          ++j;
        }
        else
        {
          cands.erase(cands.begin() + j);
          original_size -= 1;
        }
      }
      if (!all_long_enough)
      {
        vars.clear();
        for (int64_t i = 0; i < G.out_deg(r); ++i)
          vars.push_back(G.ref_var_first[r] + i);
        r += 1;
      }
      else
        break;
    }
  }

  // choose best candidates
  std::vector<const Cand *> best;
  for (auto const & c : cands)
  {
    if ((int)c.seq.size() < read_len)
      continue;
    int mm = count_mm_fwd(read, read_len, c.seq.data(), c.seq.size(), max_mm);
    if (mm > max_mm)
      continue;
    if (mm < max_mm)
    {
      max_mm = mm;
      best.clear();
    }
    best.push_back(&c);
  }

  if (!best.empty())
  {
    int64_t start_pos = s.node_order + s.offset;
    if (s.type == 'V')
    {
      int64_t rr = G.site_ref_reach(s.node_index);
      if (start_pos > rr)
        start_pos = G.get_special_pos(start_pos, rr);
    }
    for (auto const * c : best)
    {
      if (c->var_ids.empty())
        labels.push_back({start_pos, c->pos, INVALID_ID});
      else
        for (int64_t v : c->var_ids)
          labels.push_back({start_pos, c->pos, v});
    }
  }
  return max_mm;
}

// graph.cpp:1441-1700 via dfs.py get_labels_backward
static int get_labels_backward(const GraphView & G, const Location & e,
                               const uint8_t * read, int read_len, int max_mm,
                               std::vector<Label> & labels)
{
  labels.clear();
  std::vector<Cand> cands(1);
  std::vector<int64_t> vars;

  if (e.type == 'V')
  {
    int64_t v = e.node_index;
    cands[0].var_ids.push_back(v);
    append_seq(cands[0].seq, G.var_dna(v), e.offset + 1);
    if ((int)cands[0].seq.size() >= read_len)
    {
      int64_t sp = G.var_order[v] + ((int64_t)cands[0].seq.size() - read_len);
      int64_t rr = G.site_ref_reach(v);
      if (sp > rr)
        sp = G.get_special_pos(sp, rr);
      cands[0].pos = sp;
    }
    else
    {
      int64_t r = G.var_out_ref[v] - 1;
      prepend_seq(cands[0].seq, G.ref_dna(r), G.ref_dna_len[r]);
      cands[0].pos = G.ref_order[r] + ((int64_t)cands[0].seq.size() - read_len);
      if (r != 0)
        for (int64_t i = 0; i < G.out_deg(r - 1); ++i)
          vars.push_back(G.ref_var_first[r - 1] + i);
    }
  }
  else
  {
    int64_t r = e.node_index;
    if (r != 0)
      for (int64_t i = 0; i < G.out_deg(r - 1); ++i)
        vars.push_back(G.ref_var_first[r - 1] + i);
    append_seq(cands[0].seq, G.ref_dna(r), e.offset + 1);
    cands[0].pos = G.ref_order[r] + ((int64_t)cands[0].seq.size() - read_len);
  }

  if (!vars.empty() && (int)cands[0].seq.size() < read_len)
  {
    int64_t r = G.var_out_ref[vars[0]] - 1;
    bool all_long_enough = false;
    while (!all_long_enough && (int)cands.size() < MAX_VAR_AND_REFS && !vars.empty())
    {
      all_long_enough = true;
      const uint8_t * ref_codes = G.ref_dna(r);
      int64_t ref_len = G.ref_dna_len[r];
      size_t original_size = cands.size();
      size_t j = 0;
      while (j < original_size)
      {
        if ((int)cands[j].seq.size() >= read_len)
        {
          ++j;
          continue;
        }
        for (size_t i = 0; i + 1 < vars.size(); ++i)
        {
          if ((int)cands[j].seq.size() >= read_len)
            continue;  // Python re-checks inside the loop
          int64_t v = vars[i];
          Cand nc;
          nc.seq.reserve(G.var_dna_len[v] + cands[j].seq.size() + ref_len);
          append_seq(nc.seq, G.var_dna(v), G.var_dna_len[v]);
          append_seq(nc.seq, cands[j].seq.data(), cands[j].seq.size());
          bool variant_is_enough = (int)nc.seq.size() >= read_len;
          if (!variant_is_enough)
            prepend_seq(nc.seq, ref_codes, ref_len);
          if (count_mm_bwd(read, read_len, nc.seq.data(), nc.seq.size(), max_mm) <= max_mm)
          {
            nc.var_ids = cands[j].var_ids;
            nc.var_ids.push_back(v);
            if ((int)nc.seq.size() < read_len)
              all_long_enough = false;
            if (variant_is_enough)
            {
              int64_t sp = G.var_order[v] + ((int64_t)nc.seq.size() - read_len);
              int64_t rr = G.site_ref_reach(v);
              if (sp > rr)
                sp = G.get_special_pos(sp, rr);
              nc.pos = sp;
            }
            else
              nc.pos = G.ref_order[r] + ((int64_t)nc.seq.size() - read_len);
            cands.push_back(std::move(nc));
          }
        }
        int64_t last_v = vars.back();
        prepend_seq(cands[j].seq, G.var_dna(last_v), G.var_dna_len[last_v]);
        bool variant_is_enough = (int)cands[j].seq.size() >= read_len;
        if (!variant_is_enough)
          prepend_seq(cands[j].seq, ref_codes, ref_len);
        if (count_mm_bwd(read, read_len, cands[j].seq.data(), cands[j].seq.size(), max_mm) <= max_mm)
        {
          cands[j].var_ids.push_back(last_v);
          if ((int)cands[j].seq.size() < read_len)
            all_long_enough = false;
          if (variant_is_enough)
          {
            int64_t sp = G.var_order[last_v] + ((int64_t)cands[j].seq.size() - read_len);
            int64_t rr = G.site_ref_reach(last_v);
            if (sp > rr)
              sp = G.get_special_pos(sp, rr);
            cands[j].pos = sp;
          }
          else
            cands[j].pos = G.ref_order[r] + ((int64_t)cands[j].seq.size() - read_len);
          ++j;
        }
        else
        {
          cands.erase(cands.begin() + j);
          original_size -= 1;
        }
      }
      if (!all_long_enough)
      {
        if (r != 0)
        {
          r -= 1;
          vars.clear();
          for (int64_t i = 0; i < G.out_deg(r); ++i)
            vars.push_back(G.ref_var_first[r] + i);
        }
        else
        {
          vars.clear();
          break;
        }
      }
      else
        break;
    }
  }

  // NOTE the backward variant uses strict < / == instead of <=/push like
  // forward (dfs.py:362-374)
  std::vector<const Cand *> best;
  for (auto const & c : cands)
  {
    if ((int)c.seq.size() < read_len)
      continue;
    int mm = count_mm_bwd(read, read_len, c.seq.data(), c.seq.size(), max_mm);
    if (mm < max_mm)
    {
      max_mm = mm;
      best.clear();
      best.push_back(&c);
    }
    else if (mm == max_mm)
      best.push_back(&c);
  }

  if (!best.empty())
  {
    int64_t end_pos = e.node_order + e.offset;
    if (e.type == 'V')
    {
      int64_t rr = G.site_ref_reach(e.node_index);
      if (end_pos > rr)
        end_pos = G.get_special_pos(end_pos, rr);
    }
    for (auto const * c : best)
    {
      if (c->var_ids.empty())
        labels.push_back({c->pos, end_pos, INVALID_ID});
      else
        for (int64_t v : c->var_ids)
          labels.push_back({c->pos, end_pos, v});
    }
  }
  return max_mm;
}

// graph.cpp:1703-1760 via dfs.py iterative_dfs
static int iterative_dfs(const GraphView & G, const std::vector<Location> & starts,
                         const std::vector<Location> & ends,
                         const uint8_t * subread, int sub_len, int max_mm,
                         std::vector<Label> & labels)
{
  labels.clear();
  if ((int)starts.size() > MAX_LOCATIONS || (int)ends.size() > MAX_LOCATIONS)
    return max_mm;

  std::vector<Label> new_labels;
  auto add_if_better = [&](int mm) {
    if (!new_labels.empty())
    {
      if (mm < max_mm)
      {
        max_mm = mm;
        labels = new_labels;
      }
      else if (mm == max_mm)
        labels.insert(labels.end(), new_labels.begin(), new_labels.end());
    }
  };

  if (starts.size() == 1 && starts[0].is_unavailable())
  {
    for (auto const & e : ends)
    {
      int mm = get_labels_backward(G, e, subread, sub_len, max_mm, new_labels);
      add_if_better(mm);
    }
  }
  else
  {
    for (auto const & s : starts)
    {
      int mm = get_labels_forward(G, s, subread, sub_len, max_mm, new_labels);
      add_if_better(mm);
    }
  }
  return max_mm;
}

// ---------------------------------------------------------------------------
// walks + filters (genotype_paths.py)
// ---------------------------------------------------------------------------

static void walk_read_ends(const GraphView & G, Geno & g, const uint8_t * seq, int seq_len)
{
  if (g.paths.empty() || g.paths[0].size() == seq_len)
    return;
  if ((int)g.paths.size() > MAX_SEED_NUMBER_FOR_WALKING)
    return;
  int maximum_mismatches = -1;
  if ((int)g.paths.size() > MAX_SEED_NUMBER_ALLOWING_MISMATCHES)
    maximum_mismatches = 0;
  int best_mismatches = 7;
  std::vector<std::vector<Label>> best_labels;
  std::vector<int> best_end_indexes;
  std::vector<Location> s_locs;
  std::vector<Label> new_labels;
  for (auto const & path : g.paths)
  {
    if (path.rei == seq_len - 1)
      continue;
    get_locations_of_a_position(G, path.end, path, s_locs);
    if (s_locs.empty() || (int)s_locs.size() > MAX_NUM_LOCATIONS_PER_PATH)
      continue;
    const uint8_t * kmer = seq + path.rei;
    int kmer_len = seq_len - path.rei;
    int mm = (maximum_mismatches < 0) ? std::min(2 + kmer_len / 11, best_mismatches)
                                      : maximum_mismatches;
    std::vector<Location> unavailable(1);
    mm = iterative_dfs(G, s_locs, unavailable, kmer, kmer_len, mm, new_labels);
    if (!new_labels.empty())
    {
      if (mm < best_mismatches)
      {
        best_labels.assign(1, new_labels);
        best_end_indexes.assign(1, path.rei);
        best_mismatches = mm;
      }
      else if (mm == best_mismatches)
      {
        best_labels.push_back(new_labels);
        best_end_indexes.push_back(path.rei);
      }
    }
  }
  for (size_t i = 0; i < best_labels.size(); ++i)
    add_next_kmer_labels(G, g, best_labels[i], best_end_indexes[i], seq_len - 1, best_mismatches);
}

static void walk_read_starts(const GraphView & G, Geno & g, const uint8_t * seq, int seq_len)
{
  if (g.paths.empty() || g.paths[0].size() == seq_len)
    return;
  if ((int)g.paths.size() > MAX_SEED_NUMBER_FOR_WALKING)
    return;
  int maximum_mismatches = -1;
  if ((int)g.paths.size() > MAX_SEED_NUMBER_ALLOWING_MISMATCHES)
    maximum_mismatches = 0;
  int best_mismatches = 7;
  std::vector<std::vector<Label>> best_labels;
  std::vector<int> best_start_indexes;
  std::vector<Location> e_locs;
  std::vector<Label> new_labels;
  for (auto const & path : g.paths)
  {
    if (path.rsi == 0)
      continue;
    int kmer_len = path.rsi + 1;
    get_locations_of_a_position(G, path.start, path, e_locs);
    if (e_locs.empty() || (int)e_locs.size() > MAX_NUM_LOCATIONS_PER_PATH)
      continue;
    int mm = (maximum_mismatches < 0) ? std::min(2 + kmer_len / 11, best_mismatches)
                                      : maximum_mismatches;
    std::vector<Location> unavailable(1);
    mm = iterative_dfs(G, unavailable, e_locs, seq, kmer_len, mm, new_labels);
    if (!new_labels.empty())
    {
      if (mm < best_mismatches)
      {
        best_labels.assign(1, new_labels);
        best_start_indexes.assign(1, path.rsi);
        best_mismatches = mm;
      }
      else if (mm == best_mismatches)
      {
        best_labels.push_back(new_labels);
        best_start_indexes.push_back(path.rsi);
      }
    }
  }
  for (size_t i = 0; i < best_labels.size(); ++i)
    add_prev_kmer_labels(G, g, best_labels[i], 0, best_start_indexes[i], best_mismatches);
}

static bool all_paths_unique(const Geno & g)
{
  for (size_t i = 1; i < g.paths.size(); ++i)
    if (g.paths[0].start != g.paths[i].start && g.paths[0].end != g.paths[i].end)
      return false;
  return true;
}

static void remove_paths_with_too_many_mismatches(Geno & g)
{
  if (g.paths.empty())
    return;
  int min_mm = 10;
  for (auto const & p : g.paths)
    min_mm = std::min(min_mm, p.mismatches);
  size_t w = 0;
  for (size_t i = 0; i < g.paths.size(); ++i)
    if (g.paths[i].mismatches <= min_mm)
    {
      if (w != i)
        g.paths[w] = std::move(g.paths[i]);
      ++w;
    }
  g.paths.resize(w);
}

static void remove_non_ref_paths_when_read_matches_ref(Geno & g)
{
  if (all_paths_unique(g))
    return;
  bool any_ref = false;
  for (auto const & p : g.paths)
    if (p.is_reference())
    {
      any_ref = true;
      break;
    }
  if (!any_ref)
    return;
  size_t w = 0;
  for (size_t i = 0; i < g.paths.size(); ++i)
    if (g.paths[i].is_reference())
    {
      if (w != i)
        g.paths[w] = std::move(g.paths[i]);
      ++w;
    }
  g.paths.resize(w);
}

static void remove_fully_special_paths(const GraphView & G, Geno & g)
{
  size_t w = 0;
  for (size_t i = 0; i < g.paths.size(); ++i)
    if (G.get_ref_reach_pos(g.paths[i].start) != G.get_ref_reach_pos(g.paths[i].end))
    {
      if (w != i)
        g.paths[w] = std::move(g.paths[i]);
      ++w;
    }
  g.paths.resize(w);
}

// genotype_paths.py remove_support_from_read_ends (SV mode)
static void remove_support_from_read_ends(const GraphView & G, Geno & g)
{
  constexpr int64_t MIN_OFFSET = 4;
  for (auto & path : g.paths)
  {
    if (path.var_order.empty())
      continue;
    if (!G.is_special(path.start) && !G.is_special(path.end))
      continue;
    int64_t min_vo = path.var_order[0], max_vo = path.var_order[0];
    for (int64_t vo : path.var_order)
    {
      min_vo = std::min(min_vo, vo);
      max_vo = std::max(max_vo, vo);
    }
    if (G.is_special(path.end) && G.get_actual_pos(path.end) <= max_vo + MIN_OFFSET)
    {
      for (size_t i = 0; i < path.var_order.size(); ++i)
        if (path.var_order[i] == max_vo)
        {
          path.nums[i].clear();
          break;
        }
    }
    if (G.is_special(path.start))
    {
      bool ambiguous;
      if (G.is_special(path.start + MIN_OFFSET))
        ambiguous = G.get_ref_reach_pos(path.start) != G.get_ref_reach_pos(path.start + MIN_OFFSET);
      else
        ambiguous = true;
      if (ambiguous)
      {
        for (size_t i = 0; i < path.var_order.size(); ++i)
          if (path.var_order[i] == min_vo)
          {
            path.nums[i].clear();
            break;
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// seeding + full per-orientation alignment (alignment.py find_genotype_paths)
// ---------------------------------------------------------------------------

static void expand_span(const IndexView & I, int64_t a, int64_t b, std::vector<Label> & out)
{
  for (int64_t j = a; j < b; ++j)
    out.push_back({I.lab_start[j], I.lab_end[j], I.lab_var[j]});
}

// Device-computed seed candidates for one read sequence: sorted probe ids
// within [base, base + nk*97). Probe id layout: kpos_index*97 + j with j=0
// the exact kmer and j=1+kpos*3+(d-1) the Hamming-1 probe flipping 2-bit
// position kpos (shift ascending) by xor d. The candidate list comes from a
// membership bitset with NO false negatives, so probing only the listed
// candidates is bit-identical to probing all 97 keys per kmer.
struct SeedCands {
  const int64_t * b;
  const int64_t * e;
  int64_t base;
};

// Reused per-thread seeding scratch: find_genotype_paths runs once per
// aligned rep (millions per region), and the nested per-position vectors
// dominated its allocation profile. Buffers are cleared, never shrunk.
struct SeedScratch {
  std::vector<std::vector<uint64_t>> keys_per_pos;
  std::vector<char> ambiguous;
  std::vector<std::vector<Label>> h0, h1;

  void prepare(int nk)
  {
    if ((int)keys_per_pos.size() < nk)
    {
      keys_per_pos.resize(nk);
      h0.resize(nk);
      h1.resize(nk);
    }
    ambiguous.assign(nk, 0);
    for (int i = 0; i < nk; ++i)
    {
      keys_per_pos[i].clear();
      h0[i].clear();
      h1[i].clear();
    }
  }
};

static void find_genotype_paths(const GraphView & G, const IndexView & I,
                                const uint8_t * codes, int len, Geno & g,
                                const SeedCands * cands = nullptr,
                                const SeedFilter * sf = nullptr)
{
  int nk = (len < K) ? 0 : 1 + (len - K) / (K - 1);
  if (nk <= 0)
    return;
  const bool prof = prof_enabled();
  int64_t t0 = prof ? prof_now() : 0;

  // per-position keys (IUPAC fork)
  static thread_local SeedScratch scr;
  scr.prepare(nk);
  auto & keys_per_pos = scr.keys_per_pos;
  auto & ambiguous = scr.ambiguous;

  // bucket-accelerated exact-key span lookup (bit-identical to I.get)
  const bool accel = sf != nullptr && sf->bucket_bits > 0;
  auto iget = [&](uint64_t key, int64_t & a, int64_t & b) {
    if (!accel)
    {
      I.get(key, a, b);
      return;
    }
    uint64_t bkt = key >> (64 - sf->bucket_bits);
    const uint64_t * lo = I.keys + sf->bucket[bkt];
    const uint64_t * hi = I.keys + sf->bucket[bkt + 1];
    const uint64_t * it = std::lower_bound(lo, hi, key);
    if (it == hi || *it != key)
    {
      a = b = 0;
      return;
    }
    int64_t i = it - I.keys;
    a = I.offsets[i];
    b = I.offsets[i + 1];
  };
  for (int i = 0; i < nk; ++i)
  {
    int p = (K - 1) * i;
    bool amb = false;
    for (int j = p; j < p + K; ++j)
      if (codes[j] >= 4)
      {
        amb = true;
        break;
      }
    if (!amb)
    {
      uint64_t key = 0;
      for (int j = p; j < p + K; ++j)
        key = (key << 2) | codes[j];
      keys_per_pos[i].push_back(key);
    }
    else
    {
      ambiguous[i] = 1;
      to_uint64_list(codes + p, keys_per_pos[i]);
    }
  }

  // exact lookups (h0) and Hamming-1 probes (h1)
  auto & h0 = scr.h0;
  auto & h1 = scr.h1;
  if (cands != nullptr)
  {
    // device-filtered probing: only candidate (kpos, j) probes hit the index;
    // ambiguous kmers (masked out on device) fork + probe inline as below
    const int64_t * p = cands->b;
    for (int i = 0; i < nk; ++i)
    {
      int64_t lo_id = (int64_t)i * 97, hi_id = lo_id + 97;
      if (ambiguous[i])
      {
        for (uint64_t key : keys_per_pos[i])
        {
          int64_t a, b;
          iget(key, a, b);
          expand_span(I, a, b, h0[i]);
        }
        while (p < cands->e && (*p - cands->base) < hi_id)
          ++p;
        continue;
      }
      uint64_t base = keys_per_pos[i].empty() ? 0 : keys_per_pos[i][0];
      for (; p < cands->e && (*p - cands->base) < hi_id; ++p)
      {
        int64_t rem = *p - cands->base;
        if (rem < lo_id)
          continue;
        int j = (int)(rem - lo_id);
        uint64_t key = base;
        if (j > 0)
        {
          int kpos = (j - 1) / 3;
          uint64_t d = (uint64_t)((j - 1) % 3 + 1);
          key = base ^ (d << (kpos * 2));
        }
        int64_t a, b;
        iget(key, a, b);
        expand_span(I, a, b, j == 0 ? h0[i] : h1[i]);
      }
    }
  }
  else
  for (int i = 0; i < nk; ++i)
  {
    for (uint64_t key : keys_per_pos[i])
    {
      if (sf != nullptr && !sf->test_exact(key))
        continue;  // bitset miss -> key provably absent (no false negatives)
      int64_t a, b;
      iget(key, a, b);
      expand_span(I, a, b, h0[i]);
    }
    if (!ambiguous[i] && !keys_per_pos[i].empty())
    {
      uint64_t base = keys_per_pos[i][0];
      if (sf != nullptr && !sf->test_ham(base))
        continue;  // no index key within Hamming-1 of this kmer
      // probe order matches index/kmer_index.py hamming1_keys: position
      // shift ascending (3' end first), xor delta 1..3
      for (int kpos = 0; kpos < K; ++kpos)
      {
        uint64_t shift = (uint64_t)kpos * 2;
        uint64_t cur = (base >> shift) & 3ULL;
        uint64_t cleared = base & ~(3ULL << shift);
        for (uint64_t d = 1; d <= 3; ++d)
        {
          uint64_t key = cleared | ((cur ^ d) << shift);
          if (sf != nullptr && !sf->test_exact(key))
            continue;
          int64_t a, b;
          iget(key, a, b);
          expand_span(I, a, b, h1[i]);
        }
      }
    }
  }

  // max_index_labels cap (ph_index.cpp:49-57): IUPAC-forked exact lookups
  // and every Hamming-1 probe set drop entirely past the label budget (the
  // seed filter / device candidate pruning is false-negative-free, so the
  // surviving label totals equal the reference's full-probe totals)
  for (int i = 0; i < nk; ++i)
  {
    if (keys_per_pos[i].size() > 1 && (int)h0[i].size() > MAX_INDEX_LABELS)
      h0[i].clear();
    if ((int)h1[i].size() > MAX_INDEX_LABELS)
      h1[i].clear();
  }

  // stop if all kmers are extremely common
  bool all_common = true;
  for (int i = 0; i < nk; ++i)
    if ((int)h0[i].size() < MAX_UNIQUE_KMER_POSITIONS)
    {
      all_common = false;
      break;
    }
  if (all_common)
  {
    if (prof)
      prof_seed_ns.fetch_add(prof_now() - t0, std::memory_order_relaxed);
    return;
  }
  int64_t t1 = prof ? prof_now() : 0;
  if (prof)
    prof_seed_ns.fetch_add(t1 - t0, std::memory_order_relaxed);

  int read_start = 0;
  for (int i = 0; i < nk; ++i)
  {
    add_next_kmer_labels(G, g, h0[i], read_start, read_start + K - 1, 0);
    add_next_kmer_labels(G, g, h1[i], read_start, read_start + K - 1, 1);
    read_start += K - 1;
  }

  g.remove_short_paths();
  int64_t t2 = prof ? prof_now() : 0;
  if (prof)
    prof_lattice_ns.fetch_add(t2 - t1, std::memory_order_relaxed);
  walk_read_starts(G, g, codes, len);
  walk_read_ends(G, g, codes, len);
  g.update_longest();
  g.remove_short_paths();
  remove_paths_with_too_many_mismatches(g);
  if (G.is_sv)
    remove_fully_special_paths(G, g);
  remove_non_ref_paths_when_read_matches_ref(g);
  g.update_longest();
  g.remove_short_paths();
  if (G.is_sv)
    remove_support_from_read_ends(G, g);
  if (prof)
    prof_walk_ns.fetch_add(prof_now() - t2, std::memory_order_relaxed);
}

struct BatchResult {
  std::vector<int32_t> path_count;   // [2N]
  std::vector<int32_t> longest;      // [2N]
  std::vector<int64_t> p_start, p_end;
  std::vector<int32_t> p_rsi, p_rei, p_mm, p_nsites;
  std::vector<int64_t> s_vorder;
  std::vector<int32_t> s_ncount;
  std::vector<uint16_t> num_vals;
};

static void push_geno(BatchResult & R, const Geno & g)
{
  R.path_count.push_back((int32_t)g.paths.size());
  R.longest.push_back(g.longest);
  for (auto const & p : g.paths)
  {
    R.p_start.push_back(p.start);
    R.p_end.push_back(p.end);
    R.p_rsi.push_back(p.rsi);
    R.p_rei.push_back(p.rei);
    R.p_mm.push_back(p.mismatches);
    R.p_nsites.push_back((int32_t)p.var_order.size());
    for (size_t i = 0; i < p.var_order.size(); ++i)
    {
      R.s_vorder.push_back(p.var_order[i]);
      R.s_ncount.push_back((int32_t)p.nums[i].size());
      for (uint16_t x : p.nums[i])
        R.num_vals.push_back(x);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Stage 2: the full pooled caller loop (pipeline/caller.py call_pool +
// typer/scoring.py SiteScorer) for the non-SV path — dedup, mate pairing,
// orientation resolution, observation extraction, phasing connections.
// Emits the observation table the device scorer consumes.
// ---------------------------------------------------------------------------

#include <map>
#include <string>
#include <tuple>
#include <unordered_map>

namespace {

constexpr uint32_t IS_PROPER_PAIR = 0x2;
constexpr uint32_t IS_REVERSED = 0x10;
constexpr uint32_t IS_FIRST_IN_PAIR = 0x40;
constexpr uint32_t IS_MAPQ_BAD = 0x1000;
constexpr uint32_t IS_CLIPPED = 0x2000;
constexpr int EPSILON_0_EXPONENT = 12;
constexpr uint16_t NO_COVERAGE = 0xFFFF;
constexpr uint16_t MULTI_ALT_COVERAGE = 0xFFFE;
constexpr uint16_t MULTI_REF_COVERAGE = 0xFFFD;

// per-orientation read metadata mirroring GenotypePaths fields that scoring
// consumes (typer/alignment.py update_paths / update_unpaired_read_paths)
struct GenoMeta {
  uint32_t flags = 0;
  int32_t mapq = 255;
  int32_t score_diff = 0;
  const uint8_t * qual = nullptr;  // raw phred, fwd order
  int32_t qual_len = 0;
  bool qual_reversed = false;
};

struct SiteView {
  const int64_t * site_order;  // [S] var order per site (ascending)
  const int64_t * site_cnum;
  const uint8_t * site_is_snp;
  int64_t n_sites;

  int64_t id2hap(int64_t var_order) const
  {
    const int64_t * it = std::lower_bound(site_order, site_order + n_sites, var_order);
    return it - site_order;  // caller guarantees presence
  }
};

struct HostObs {  // >64-allele sites: explains emitted verbatim
  std::vector<uint16_t> explains;
};

struct CallResult {
  // observation table (ops/site_scoring.py OBS_FIELDS, plus cnum for tiering)
  std::vector<int32_t> o_site, o_sample, o_eps, o_cov;
  std::vector<int32_t> o_clip_scaled, o_mapq_sq, o_mm_scaled, o_sdiff;
  std::vector<uint8_t> o_apply, o_clip_flag, o_strand, o_proper;
  std::vector<uint32_t> o_bits_lo, o_bits_hi;
  // big-site explains (cnum > 64): CSR into x_vals, one row per obs row
  // flagged by o_big
  std::vector<uint8_t> o_big;
  std::vector<int32_t> x_count;
  std::vector<uint16_t> x_vals;
  // phasing connections: (hap1, pn, b1, hap2) -> counts[num2]
  std::map<std::tuple<int64_t, int32_t, int32_t, int64_t>, std::vector<int64_t>> conn;
  // (hap1, pn, b1) buckets touched even with no targets (the Python scorer
  // setdefault-creates them; compute_ph_map treats them as inert)
  std::map<std::tuple<int64_t, int32_t, int32_t>, char> conn_touched;
  std::vector<int64_t> eps_sum;  // [S * P]
  int64_t num_records = 0;
  int64_t num_duplicated = 0;
  int32_t error = 0;

  // flattened connections (filled by finalize_conn)
  std::vector<int64_t> c_hap1, c_hap2;
  std::vector<int32_t> c_pn, c_b1, c_ncounts;
  std::vector<int64_t> c_counts;

  std::vector<int64_t> t_hap1;
  std::vector<int32_t> t_pn, t_b1;

  void finalize_conn()
  {
    for (auto const & kv : conn_touched)
    {
      t_hap1.push_back(std::get<0>(kv.first));
      t_pn.push_back(std::get<1>(kv.first));
      t_b1.push_back(std::get<2>(kv.first));
    }
    for (auto const & kv : conn)
    {
      c_hap1.push_back(std::get<0>(kv.first));
      c_pn.push_back(std::get<1>(kv.first));
      c_b1.push_back(std::get<2>(kv.first));
      c_hap2.push_back(std::get<3>(kv.first));
      c_ncounts.push_back((int32_t)kv.second.size());
      c_counts.insert(c_counts.end(), kv.second.begin(), kv.second.end());
    }
  }
};

// SV-mode context (pipeline/caller.py call_pool SV branches): the
// is_good_sv_read verdicts, the 50bp/3x coverage bins, and the per-sample
// ReferenceDepth track (reference_depth.cpp) that sv_reformat consumes.
struct SvCtx {
  const uint8_t * sv_bad;  // [n_reads] 1 = fails is_good_sv_read
  const double * avg_cov;  // [n_samples] avg_cov_by_readlen, or nullptr
  int64_t first_pos;       // pos of the pool's first record (pre-filter)
  int32_t * depth;         // [n_samples * ref_size] out (caller zeroes)
  int64_t ref_size;
  int64_t ref_offset;      // graph.ref_nodes[0].label.order
};

struct CallCtx {
  const GraphView * G;
  const SiteView * S;
  int32_t n_samples;
  bool hq_reads;
  CallResult * R;
  const SvCtx * sv = nullptr;
};

// reference_depth.cpp add_genotype_paths: +1 over the ref-reach span of the
// winning path, saturating at 0xFFFF
static void sv_depth_add(const CallCtx & C, const Geno & g, int32_t pn)
{
  if (g.paths.empty())
    return;
  const Path & p = g.paths[0];
  int64_t start = C.G->get_ref_reach_pos(p.start) - C.sv->ref_offset;
  int64_t end = C.G->get_ref_reach_pos(p.end) - C.sv->ref_offset;
  if (start < 0)
    start = 0;
  int64_t stop = std::min<int64_t>(C.sv->ref_size, end + 1);
  int32_t * d = C.sv->depth + (int64_t)pn * C.sv->ref_size;
  for (int64_t i = start; i < stop; ++i)
    d[i] = std::min<int32_t>(d[i] + 1, 0xFFFF);
}

// typer/scoring.py are_genotype_paths_good
static bool are_genotype_paths_good(const Geno & g, const CallCtx & C)
{
  if (g.paths.empty())
    return false;
  bool fully_aligned = true;
  for (auto const & p : g.paths)
    if (p.size() != g.read_length)
    {
      fully_aligned = false;
      break;
    }
  if (!fully_aligned && (!all_paths_unique(g) || g.paths[0].size() < 63))
    return false;
  double mismatch_ratio = (double)g.paths[0].mismatches / (double)g.paths[0].size();
  if (mismatch_ratio > 0.05)
    return false;
  if (!fully_aligned && mismatch_ratio > 0.025)
    return false;
  if (C.G->is_sv)
  {
    if (!fully_aligned || g.paths[0].size() < 90 || mismatch_ratio > 0.03)
      return false;
  }
  if (C.hq_reads)
  {
    if (!fully_aligned || g.paths[0].size() < 90 || mismatch_ratio > 0.035)
      return false;
  }
  return true;
}

static int epsilon_exponent(bool non_unique, uint32_t flags, bool fully_aligned,
                            bool overlapping, bool low_qual, int mismatches)
{
  int e = EPSILON_0_EXPONENT;
  e -= mismatches;
  if (non_unique)
    e -= 3;
  if (flags & IS_MAPQ_BAD)
    e -= 2;
  if (!fully_aligned)
    e -= 3;
  if (!overlapping)
    e -= 1;
  if (low_qual)
    e -= 2;
  return std::max(e, 8) - 4;
}

static uint16_t add_cov(uint16_t cov, uint16_t c)
{
  if (cov == NO_COVERAGE)
    return c;
  if (cov == MULTI_ALT_COVERAGE)
    return c == 0 ? MULTI_REF_COVERAGE : MULTI_ALT_COVERAGE;
  if (cov == MULTI_REF_COVERAGE)
    return MULTI_REF_COVERAGE;
  if (cov != c)
    return (cov == 0 || c == 0) ? MULTI_REF_COVERAGE : MULTI_ALT_COVERAGE;
  return cov;
}

// per-read extraction + observation emission; returns the read's connection
// map (typer/scoring.py push_to_haplotype_scores)
using ReadConns = std::map<std::pair<int64_t, int32_t>, std::vector<std::pair<int64_t, int32_t>>>;

static ReadConns push_to_haplotype_scores(const CallCtx & C, const Geno & g, const GenoMeta & m,
                                          int32_t pn)
{
  const GraphView & G = *C.G;
  CallResult & R = *C.R;
  int32_t clipped_bp = g.read_length - g.longest;
  bool fully_aligned = clipped_bp == 0;
  bool non_unique = !all_paths_unique(g);
  int mismatches = g.paths[0].mismatches;
  bool low_qual = false;

  // ordered per-site state (std::map = sorted iteration like Python's
  // sorted(recent_ids))
  struct SiteObs {
    std::vector<uint16_t> explains;  // sorted unique
    uint16_t cov = NO_COVERAGE;
    bool overlapping = false;
  };
  std::map<int64_t, SiteObs> site_obs;

  for (auto const & path : g.paths)
  {
    for (size_t i = 0; i < path.var_order.size(); ++i)
    {
      if (path.nums[i].empty())
        continue;
      int64_t vo = path.var_order[i];
      int64_t hap_id = C.S->id2hap(vo);
      constexpr int64_t MIN_OFFSET = 3;
      bool overlapping = G.get_ref_reach_pos(path.start) + MIN_OFFSET <= vo &&
                         G.get_ref_reach_pos(path.end) - MIN_OFFSET > vo;
      auto & obs = site_obs[hap_id];
      obs.overlapping = obs.overlapping || overlapping;

      if (!low_qual && C.S->site_is_snp[hap_id] && m.qual)
      {
        int64_t offset = vo - G.get_actual_pos(path.start);
        if (offset >= 0 && offset < m.qual_len)
        {
          uint8_t q = m.qual_reversed ? m.qual[m.qual_len - 1 - offset] : m.qual[offset];
          low_qual = q < 25;
        }
      }

      for (uint16_t x : path.nums[i])
        nums_insert(obs.explains, x);
      if (path.nums[i].size() == 1)
        obs.cov = add_cov(obs.cov, path.nums[i][0]);
      else
      {
        obs.cov = add_cov(obs.cov, 1);
        bool has0 = std::binary_search(path.nums[i].begin(), path.nums[i].end(), (uint16_t)0);
        obs.cov = add_cov(obs.cov, has0 ? 0 : 2);
      }
    }
  }

  // phasing connections (vcf_writer.cpp:587-638 semantics)
  ReadConns new_conns;
  {
    std::vector<std::pair<int64_t, const SiteObs *>> ids;
    ids.reserve(site_obs.size());
    for (auto const & kv : site_obs)
      ids.push_back({kv.first, &kv.second});
    for (size_t i1 = 0; i1 < ids.size(); ++i1)
    {
      size_t n1 = ids[i1].second->explains.size();
      if (n1 == 0 || n1 > 64)
        continue;
      for (uint16_t b1 : ids[i1].second->explains)
      {
        auto & conn = new_conns[{ids[i1].first, (int32_t)b1}];
        for (size_t i2 = i1 + 1; i2 < ids.size(); ++i2)
        {
          size_t n2 = ids[i2].second->explains.size();
          if (n2 == 0 || n2 > 64)
            continue;
          size_t weight = n1 * n2;
          int repeat = (weight >= 3) ? (int)(6 / weight) : 1;
          for (uint16_t b2 : ids[i2].second->explains)
            for (int rep = 0; rep < repeat; ++rep)
              conn.push_back({ids[i2].first, (int32_t)b2});
        }
      }
    }
  }

  // observation emission (ops/site_scoring.py ObsBatcher.add)
  int32_t clip_scaled = clipped_bp ? (clipped_bp * 1000) / g.read_length : 0;
  int32_t mapq_sq = (m.mapq == 255) ? 0 : m.mapq * m.mapq;
  int32_t mm_scaled = mismatches ? (mismatches * 1000) / g.read_length : 0;
  bool forward = (m.flags & IS_REVERSED) == 0;
  bool first = (m.flags & IS_FIRST_IN_PAIR) != 0;
  uint8_t strand = (forward ? 0 : 2) + (first ? 0 : 1);
  uint8_t proper = (m.flags & IS_PROPER_PAIR) ? 1 : 0;

  for (auto const & kv : site_obs)
  {
    int64_t hap_id = kv.first;
    const SiteObs & obs = kv.second;
    int64_t cnum = C.S->site_cnum[hap_id];
    int eps = epsilon_exponent(non_unique, m.flags, fully_aligned, obs.overlapping,
                               low_qual, mismatches);
    int64_t & es = R.eps_sum[hap_id * C.n_samples + pn];
    bool apply = es < 0xFFFF - eps;
    if (apply)
      es += eps;
    int32_t cov_code;
    if (obs.cov == MULTI_ALT_COVERAGE)
      cov_code = -1;
    else if (obs.cov == MULTI_REF_COVERAGE)
      cov_code = -2;
    else
      cov_code = (int32_t)obs.cov;
    R.o_site.push_back((int32_t)hap_id);
    R.o_sample.push_back(pn);
    R.o_eps.push_back(eps);
    R.o_apply.push_back(apply ? 1 : 0);
    R.o_cov.push_back(cov_code);
    R.o_clip_scaled.push_back(clip_scaled);
    R.o_clip_flag.push_back(clipped_bp ? 1 : 0);
    R.o_mapq_sq.push_back(mapq_sq);
    R.o_mm_scaled.push_back(mm_scaled);
    R.o_sdiff.push_back(m.score_diff);
    R.o_strand.push_back(strand);
    R.o_proper.push_back(proper);
    if (cnum <= 64)
    {
      uint32_t lo = 0, hi = 0;
      for (uint16_t a : obs.explains)
      {
        if (a < cnum)
        {
          if (a < 32)
            lo |= 1u << a;
          else
            hi |= 1u << (a - 32);
        }
      }
      R.o_bits_lo.push_back(lo);
      R.o_bits_hi.push_back(hi);
      R.o_big.push_back(0);
      R.x_count.push_back(0);
    }
    else
    {
      R.o_bits_lo.push_back(0);
      R.o_bits_hi.push_back(0);
      R.o_big.push_back(1);
      int32_t cnt = 0;
      for (uint16_t a : obs.explains)
        if (a < cnum)
        {
          R.x_vals.push_back(a);
          ++cnt;
        }
      R.x_count.push_back(cnt);
    }
  }
  return new_conns;
}

static void add_connections(CallResult & R, const ReadConns & merged, int32_t pn,
                            const SiteView & S)
{
  for (auto const & kv : merged)
  {
    R.conn_touched[{kv.first.first, pn, kv.first.second}] = 1;
    for (auto const & tgt : kv.second)
    {
      auto key = std::make_tuple(kv.first.first, pn, kv.first.second, tgt.first);
      auto & arr = R.conn[key];
      if (arr.empty())
        arr.assign(S.site_cnum[tgt.first], 0);
      arr[tgt.second] += 1;
    }
  }
}

static void update_haplotype_scores_single(const CallCtx & C, const Geno & g, const GenoMeta & m,
                                           int32_t pn)
{
  if (!are_genotype_paths_good(g, C))
    return;
  ReadConns c1 = push_to_haplotype_scores(C, g, m, pn);
  add_connections(*C.R, c1, pn, *C.S);
}

static void update_haplotype_scores_pair(const CallCtx & C, const Geno & g1, const GenoMeta & m1,
                                         const Geno & g2, const GenoMeta & m2, int32_t pn)
{
  bool good1 = are_genotype_paths_good(g1, C);
  bool good2 = are_genotype_paths_good(g2, C);
  ReadConns c1, c2;
  if (good1)
    c1 = push_to_haplotype_scores(C, g1, m1, pn);
  if (good2)
    c2 = push_to_haplotype_scores(C, g2, m2, pn);
  ReadConns merged;
  if (!c1.empty() || !c2.empty())
  {
    for (auto const & kv : c1)
    {
      auto & tg = merged[kv.first];
      tg = kv.second;
      for (auto const & kv2 : c2)
        if (kv2.first.first > kv.first.first)
          tg.push_back({kv2.first.first, kv2.first.second});
    }
    for (auto const & kv : c2)
    {
      auto it = merged.find(kv.first);
      if (it != merged.end())
        it->second.insert(it->second.end(), kv.second.begin(), kv.second.end());
      else
        merged[kv.first] = kv.second;
      auto & tg = merged[kv.first];
      for (auto const & kv1 : c1)
        if (kv1.first.first > kv.first.first)
          tg.push_back({kv1.first.first, kv1.first.second});
    }
  }
  add_connections(*C.R, merged, pn, *C.S);
}

// genotype_paths.py compare_single
static int compare_single(const Geno & g1, const Geno & g2)
{
  int m1 = g1.longest, m2 = g2.longest;
  constexpr int MINIMUM_PATH_SIZE = 94;
  if (m1 > m2 && m1 > MINIMUM_PATH_SIZE)
    return 1;
  if (m2 > m1 && m2 > MINIMUM_PATH_SIZE)
    return 2;
  if (m1 == m2 && m1 > MINIMUM_PATH_SIZE)
    return g1.paths[0].mismatches <= g2.paths[0].mismatches ? 1 : 2;
  return 0;
}

// genotype_paths.py compare_pairs
static int compare_pairs(const Geno & g1f, const Geno & g1s, const Geno & g2f, const Geno & g2s)
{
  int m11 = g1f.paths.empty() ? 0 : g1f.longest;
  int m12 = g1s.paths.empty() ? 0 : g1s.longest;
  int m21 = g2f.paths.empty() ? 0 : g2f.longest;
  int m22 = g2s.paths.empty() ? 0 : g2s.longest;
  int max1 = std::max(m11, m12);
  int max2 = std::max(m21, m22);
  int perfect1 = g1f.read_length;
  int perfect2 = g1s.read_length;
  constexpr int MINIMUM_PATH_SIZE = 94;

  auto alt_count = [](const Geno & g) {
    int c = 0;
    for (auto const & p : g.paths)
      for (auto const & num : p.nums)
        if (!std::binary_search(num.begin(), num.end(), (uint16_t)0))
          ++c;
    return c;
  };

  if ((m11 >= perfect1 && m12 >= perfect2) || (m21 >= perfect1 && m22 >= perfect2))
  {
    if ((m11 >= perfect1 && m12 >= perfect2) && (m21 >= perfect1 && m22 >= perfect2))
    {
      int mm1 = g1f.paths[0].mismatches + g1s.paths[0].mismatches;
      int mm2 = g2f.paths[0].mismatches + g2s.paths[0].mismatches;
      if (mm1 < mm2)
        return 1;
      if (mm2 < mm1)
        return 2;
      int np1 = (int)(g1f.paths.size() + g1s.paths.size());
      int np2 = (int)(g2f.paths.size() + g2s.paths.size());
      if (np1 < np2)
        return 1;
      if (np2 < np1)
        return 2;
      int c1 = alt_count(g1f) + alt_count(g1s);
      int c2 = alt_count(g2f) + alt_count(g2s);
      return c1 >= c2 ? 1 : 2;
    }
    if (m11 >= perfect1 && m12 >= perfect2)
      return 1;
    return 2;
  }
  if (max2 >= MINIMUM_PATH_SIZE && max2 > max1)
    return 2;
  if (max1 >= MINIMUM_PATH_SIZE && max1 > max2)
    return 1;
  if (max1 >= MINIMUM_PATH_SIZE && max2 >= MINIMUM_PATH_SIZE)
  {
    int mm1 = 10;
    if (m11 == max1 && !g1f.paths.empty())
      mm1 = std::min(mm1, g1f.paths[0].mismatches);
    if (m12 == max1 && !g1s.paths.empty())
      mm1 = std::min(mm1, g1s.paths[0].mismatches);
    int mm2 = 10;
    if (m21 == max2 && !g2f.paths.empty())
      mm2 = std::min(mm2, g2f.paths[0].mismatches);
    if (m22 == max2 && !g2s.paths.empty())
      mm2 = std::min(mm2, g2s.paths[0].mismatches);
    if (mm1 < mm2)
      return 1;
    if (mm2 < mm1)
      return 2;
    if (std::min(m11, m12) < std::min(m21, m22))
      return 1;
    if (std::min(m21, m22) < std::min(m11, m12))
      return 2;
    return 0;
  }
  if (max2 == 0 && m11 >= 63 && m12 >= 63)
    return 1;
  if (max1 == 0 && m21 >= 63 && m22 >= 63)
    return 2;
  return 1;  // fallback needed for SV calling
}

}  // namespace

extern "C" {

void * gt_align_batch(
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  int32_t is_sv_graph,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // reads
  const uint8_t * read_codes, const int64_t * read_off, int64_t n_reads,
  const int32_t * flags, const int32_t * tlen, const uint8_t * same_ref,
  int32_t force_both, int32_t n_threads,
  // optional seed filter handle from gt_seed_filter_build (nullable)
  void * seed_filter,
  // out sizes
  int64_t * out_n_paths, int64_t * out_n_sites, int64_t * out_n_nums)
{
  GraphView G{ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
              var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
              sp_ref_reach, sp_actual, n_special, is_sv_graph != 0};
  IndexView I{keys, n_keys, offsets, lab_start, lab_end, lab_var};
  const SeedFilter * sf = (const SeedFilter *)seed_filter;

  auto align_range = [&](int64_t lo, int64_t hi, BatchResult & R) {
    std::vector<uint8_t> rcodes;
    for (int64_t r = lo; r < hi; ++r)
    {
      const uint8_t * codes = read_codes + read_off[r];
      int len = (int)(read_off[r + 1] - read_off[r]);
      Geno g1, g2;
      g1.read_length = g2.read_length = len;
      if (len >= 2 * K - 1)
      {
        // alignment.py align_read: forward always; reverse complement unless
        // proper-pair geometry
        bool proper_geometry =
          (flags[r] & IS_PAIRED) == 0 ||
          (same_ref[r] && -1200 < tlen[r] && tlen[r] < 1200 &&
           ((flags[r] & 0x10) != 0) != ((flags[r] & 0x20) != 0));
        find_genotype_paths(G, I, codes, len, g1, nullptr, sf);
        if (!proper_geometry || force_both)
        {
          rcodes.resize(len);
          for (int i = 0; i < len; ++i)
            rcodes[i] = CODE_COMP[codes[len - 1 - i] & 15];
          find_genotype_paths(G, I, rcodes.data(), len, g2, nullptr, sf);
        }
      }
      push_geno(R, g1);
      push_geno(R, g2);
    }
  };

  BatchResult * result = new BatchResult();
  if (n_threads <= 1 || n_reads < 64)
  {
    align_range(0, n_reads, *result);
  }
  else
  {
    int nt = std::min<int64_t>(n_threads, (n_reads + 63) / 64);
    std::vector<BatchResult> parts(nt);
    std::vector<std::thread> threads;
    int64_t per = (n_reads + nt - 1) / nt;
    for (int t = 0; t < nt; ++t)
    {
      int64_t lo = t * per, hi = std::min(n_reads, (t + 1) * per);
      if (lo >= hi)
        break;
      threads.emplace_back([&, lo, hi, t]() { align_range(lo, hi, parts[t]); });
    }
    for (auto & th : threads)
      th.join();
    for (auto & p : parts)
    {
      result->path_count.insert(result->path_count.end(), p.path_count.begin(), p.path_count.end());
      result->longest.insert(result->longest.end(), p.longest.begin(), p.longest.end());
      result->p_start.insert(result->p_start.end(), p.p_start.begin(), p.p_start.end());
      result->p_end.insert(result->p_end.end(), p.p_end.begin(), p.p_end.end());
      result->p_rsi.insert(result->p_rsi.end(), p.p_rsi.begin(), p.p_rsi.end());
      result->p_rei.insert(result->p_rei.end(), p.p_rei.begin(), p.p_rei.end());
      result->p_mm.insert(result->p_mm.end(), p.p_mm.begin(), p.p_mm.end());
      result->p_nsites.insert(result->p_nsites.end(), p.p_nsites.begin(), p.p_nsites.end());
      result->s_vorder.insert(result->s_vorder.end(), p.s_vorder.begin(), p.s_vorder.end());
      result->s_ncount.insert(result->s_ncount.end(), p.s_ncount.begin(), p.s_ncount.end());
      result->num_vals.insert(result->num_vals.end(), p.num_vals.begin(), p.num_vals.end());
    }
  }

  *out_n_paths = (int64_t)result->p_start.size();
  *out_n_sites = (int64_t)result->s_vorder.size();
  *out_n_nums = (int64_t)result->num_vals.size();
  return result;
}

int32_t gt_align_fetch(void * handle,
                       int32_t * path_count, int32_t * longest,
                       int64_t * p_start, int64_t * p_end,
                       int32_t * p_rsi, int32_t * p_rei, int32_t * p_mm, int32_t * p_nsites,
                       int64_t * s_vorder, int32_t * s_ncount, uint16_t * num_vals)
{
  BatchResult * R = static_cast<BatchResult *>(handle);
  if (!R)
    return -1;
  memcpy(path_count, R->path_count.data(), R->path_count.size() * sizeof(int32_t));
  memcpy(longest, R->longest.data(), R->longest.size() * sizeof(int32_t));
  memcpy(p_start, R->p_start.data(), R->p_start.size() * sizeof(int64_t));
  memcpy(p_end, R->p_end.data(), R->p_end.size() * sizeof(int64_t));
  memcpy(p_rsi, R->p_rsi.data(), R->p_rsi.size() * sizeof(int32_t));
  memcpy(p_rei, R->p_rei.data(), R->p_rei.size() * sizeof(int32_t));
  memcpy(p_mm, R->p_mm.data(), R->p_mm.size() * sizeof(int32_t));
  memcpy(p_nsites, R->p_nsites.data(), R->p_nsites.size() * sizeof(int32_t));
  memcpy(s_vorder, R->s_vorder.data(), R->s_vorder.size() * sizeof(int64_t));
  memcpy(s_ncount, R->s_ncount.data(), R->s_ncount.size() * sizeof(int32_t));
  memcpy(num_vals, R->num_vals.data(), R->num_vals.size() * sizeof(uint16_t));
  return 0;
}

void gt_align_free(void * handle)
{
  delete static_cast<BatchResult *>(handle);
}

// ---------------------------------------------------------------------------
// Stage 2 entry: full pooled caller loop (non-SV).
// ---------------------------------------------------------------------------

// Concatenate per-worker stage-2 results into R (worker order; sample
// ranges are disjoint so eps columns and conn keys never clash).
static void merge_worker_parts(CallResult * R, std::vector<CallResult> & parts,
                               const std::vector<std::pair<int32_t, int32_t>> & ranges,
                               int64_t n_sites, int32_t n_samples)
{
  for (size_t ti = 0; ti < ranges.size(); ++ti)
  {
    CallResult & W = parts[ti];
    if (W.error)
      R->error = W.error;
    auto cat = [](auto & dst, auto & src) {
      dst.insert(dst.end(), src.begin(), src.end());
      src.clear();
    };
    cat(R->o_site, W.o_site);
    cat(R->o_sample, W.o_sample);
    cat(R->o_eps, W.o_eps);
    cat(R->o_apply, W.o_apply);
    cat(R->o_cov, W.o_cov);
    cat(R->o_clip_scaled, W.o_clip_scaled);
    cat(R->o_clip_flag, W.o_clip_flag);
    cat(R->o_mapq_sq, W.o_mapq_sq);
    cat(R->o_mm_scaled, W.o_mm_scaled);
    cat(R->o_sdiff, W.o_sdiff);
    cat(R->o_strand, W.o_strand);
    cat(R->o_proper, W.o_proper);
    cat(R->o_bits_lo, W.o_bits_lo);
    cat(R->o_bits_hi, W.o_bits_hi);
    cat(R->o_big, W.o_big);
    cat(R->x_count, W.x_count);
    cat(R->x_vals, W.x_vals);
    for (int64_t site = 0; site < n_sites; ++site)
      for (int32_t pn = ranges[ti].first; pn < ranges[ti].second; ++pn)
        R->eps_sum[site * n_samples + pn] = W.eps_sum[site * n_samples + pn];
    R->conn.insert(W.conn.begin(), W.conn.end());
    R->conn_touched.insert(W.conn_touched.begin(), W.conn_touched.end());
  }
}

// One pair-pending record in the stage-2 pooled loop. Owns its qual bytes
// so entries can outlive the batch buffers they were parsed from (the
// streaming caller frees each batch after replay; mates may arrive in a
// later batch).
struct Pending {
  Geno g1, g2;
  GenoMeta m1, m2;
  std::vector<uint8_t> qual_store;
  int64_t ins_seq = 0;  // map insertion order (Python dict order, SV leftovers)
};

// typer/alignment.py update_paths: derive the fwd/rc metadata of one record
static void make_metas_arrays(uint32_t flagv, int32_t mapqv, int32_t clipv, int32_t sdiffv,
                              const uint8_t * qual, int32_t qlen, GenoMeta & m1, GenoMeta & m2)
{
  m1.flags = flagv & ~IS_PROPER_PAIR;
  m1.mapq = mapqv;
  if (mapqv < 25)
    m1.flags |= IS_MAPQ_BAD;
  m2.flags = (flagv ^ IS_REVERSED) & ~IS_PROPER_PAIR;
  if (mapqv < 25)
    m2.flags |= IS_MAPQ_BAD;
  if (clipv > 3)
  {
    m1.flags |= IS_CLIPPED;
    m2.flags |= IS_CLIPPED;
  }
  m1.score_diff = m2.score_diff = sdiffv;
  m2.mapq = m1.mapq;
  if (qlen > 0)
  {
    m1.qual = qual;
    m1.qual_len = qlen;
    m1.qual_reversed = false;
    m2.qual = qual;
    m2.qual_len = qlen;
    m2.qual_reversed = true;
  }
}

// Process one pooled record through dedup-aware pairing + scoring — the body
// of the stage-2 loop, shared by the in-memory and streaming callers.
// Returns false on the both-mates-same-slot error (Python raises there).
static bool stage2_one_record(const CallCtx & Cw, int32_t rg, uint32_t flagv, int32_t mapqv,
                              int32_t clipv, int32_t sdiffv, const uint8_t * qual, int32_t qlen,
                              std::string && name, const Geno & a1, const Geno & a2,
                              std::unordered_map<std::string, Pending> & map,
                              int64_t * ins_counter = nullptr)
{
  auto it = map.find(name);
  if (it == map.end())
  {
    if (flagv & IS_PAIRED)
    {
      Pending p;
      p.g1 = a1;
      p.g2 = a2;
      p.qual_store.assign(qual, qual + qlen);
      make_metas_arrays(flagv, mapqv, clipv, sdiffv, p.qual_store.data(), qlen, p.m1, p.m2);
      if (ins_counter)
        p.ins_seq = (*ins_counter)++;
      map.emplace(std::move(name), std::move(p));
    }
    else
    {
      // typer/alignment.py update_unpaired_read_paths
      int cmp = compare_single(a1, a2);
      if (cmp != 0)
      {
        const Geno & g = (cmp == 1) ? a1 : a2;
        GenoMeta m;
        m.flags = (cmp == 1) ? (flagv & ~IS_PROPER_PAIR) : ((flagv ^ IS_REVERSED) & ~IS_PROPER_PAIR);
        m.mapq = mapqv;
        if (mapqv < 25)
          m.flags |= IS_MAPQ_BAD;
        if (clipv > 3)
          m.flags |= IS_CLIPPED;
        m.score_diff = sdiffv;
        if (qlen > 0)
        {
          m.qual = qual;
          m.qual_len = qlen;
          m.qual_reversed = cmp != 1;
        }
        update_haplotype_scores_single(Cw, g, m, rg);
      }
    }
    return true;
  }

  Pending mine;
  mine.g1 = a1;
  mine.g2 = a2;
  make_metas_arrays(flagv, mapqv, clipv, sdiffv, qual, qlen, mine.m1, mine.m2);
  Pending & found = it->second;
  if ((mine.m1.flags & IS_FIRST_IN_PAIR) == (found.m1.flags & IS_FIRST_IN_PAIR))
    return false;
  // typer/alignment.py get_better_paths: slot by (first, !reversed)
  const Geno * arr_g[4] = {nullptr, nullptr, nullptr, nullptr};
  const GenoMeta * arr_m[4] = {nullptr, nullptr, nullptr, nullptr};
  auto put = [&](const Geno & g, const GenoMeta & m) {
    int idx = (int)((m.flags & IS_FIRST_IN_PAIR) != 0) + 2 * (int)((m.flags & IS_REVERSED) == 0);
    arr_g[idx] = &g;
    arr_m[idx] = &m;
  };
  put(found.g1, found.m1);
  put(found.g2, found.m2);
  put(mine.g1, mine.m1);
  put(mine.g2, mine.m2);
  bool all_present = arr_g[0] && arr_g[1] && arr_g[2] && arr_g[3];
  if (all_present)
  {
    int cmp = compare_pairs(*arr_g[3], *arr_g[0], *arr_g[1], *arr_g[2]);
    if (cmp == 1 || cmp == 2)
    {
      const Geno * gf = (cmp == 1) ? arr_g[3] : arr_g[1];
      const Geno * gs = (cmp == 1) ? arr_g[0] : arr_g[2];
      GenoMeta mf = (cmp == 1) ? *arr_m[3] : *arr_m[1];
      GenoMeta ms = (cmp == 1) ? *arr_m[0] : *arr_m[2];
      mf.flags |= IS_PROPER_PAIR;
      ms.flags |= IS_PROPER_PAIR;
      if (Cw.sv)
      {
        sv_depth_add(Cw, *gf, rg);
        sv_depth_add(Cw, *gs, rg);
      }
      update_haplotype_scores_pair(Cw, *gf, mf, *gs, ms, rg);
    }
  }
  map.erase(it);
  return true;
}

// SV leftover mates (pipeline/caller.py call_pool:436-447): the reference
// keeps unmatched mates in SV mode — flip FIRST/REVERSED on cloned metadata
// (qual orientation stays, matching Python's clone), resolve the better
// orientation pair, and score the winner as a single read with proper-pair
// set (get_better_paths marks the winning pair before returning).
static void process_leftover_mate(const CallCtx & Cw, const Pending & p, int32_t rg)
{
  GenoMeta f1 = p.m1, f2 = p.m2;
  f1.flags ^= IS_FIRST_IN_PAIR | IS_REVERSED;
  f2.flags ^= IS_FIRST_IN_PAIR | IS_REVERSED;
  const Geno * arr_g[4] = {nullptr, nullptr, nullptr, nullptr};
  const GenoMeta * arr_m[4] = {nullptr, nullptr, nullptr, nullptr};
  auto put = [&](const Geno & g, const GenoMeta & m) {
    int idx = (int)((m.flags & IS_FIRST_IN_PAIR) != 0) + 2 * (int)((m.flags & IS_REVERSED) == 0);
    arr_g[idx] = &g;
    arr_m[idx] = &m;
  };
  put(p.g1, p.m1);
  put(p.g2, p.m2);
  put(p.g1, f1);
  put(p.g2, f2);
  if (!(arr_g[0] && arr_g[1] && arr_g[2] && arr_g[3]))
    return;
  int cmp = compare_pairs(*arr_g[3], *arr_g[0], *arr_g[1], *arr_g[2]);
  if (cmp != 1 && cmp != 2)
    return;
  const Geno * gf = (cmp == 1) ? arr_g[3] : arr_g[1];
  GenoMeta mf = (cmp == 1) ? *arr_m[3] : *arr_m[1];
  mf.flags |= IS_PROPER_PAIR;
  sv_depth_add(Cw, *gf, rg);
  update_haplotype_scores_single(Cw, *gf, mf, rg);
}

// Seed candidates for a whole pool, as the device kernel's packed bitmask:
// bit (row, kpos*97 + j) set means probe j of kmer kpos of device row `row`
// passed the membership filter and must be verified against the index.
// prow = words per row = ceil(nk_max*97 / 32).
struct CandView {
  const uint32_t * words;
  int64_t prow;
  int32_t nk_max;
  const int64_t * rep_row_fwd;  // [n_reps] row index or -1
  const int64_t * rep_row_rc;

  void collect(int64_t row, std::vector<int64_t> & out) const
  {
    out.clear();
    const uint32_t * w = words + row * prow;
    for (int64_t wi = 0; wi < prow; ++wi)
    {
      uint32_t v = w[wi];
      while (v)
      {
        int b = __builtin_ctz(v);
        out.push_back(wi * 32 + b);
        v &= v - 1;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// device-resident alignment verdicts (ops/device_align.py)
// ---------------------------------------------------------------------------

// One device dispatch per batch resolves each read-orientation row to either a
// complete "clean" alignment (single exact-seed chain + in-node tail — see
// ops/device_align.py for the parity argument) or a host fallback. Clean
// rows synthesize their Geno here, skipping seed+lattice+walk entirely; the
// verify mode runs both and compares byte-for-byte.
static constexpr int VERD_COLS = 9;  // meta (verdict | mm<<1 | nv<<4), start, end, slot0..5

struct VerdView {
  const int32_t * rows;  // [n_rows * VERD_COLS]
  const int64_t * rep_row_fwd;  // [n_reps] row or -1
  const int64_t * rep_row_rc;
  int32_t verify;
};

// Externally-computed rep alignment results (rep-sharded distributed mode,
// parallel/rep_shard.py): hosts split the cohort's deduplicated oriented
// read-sequence space, align their share via gt_align_batch, allgather the
// serialized Geno tables, and inject them here so the local align stage
// skips find_genotype_paths for every resolved row. The serialization is
// the gt_align_fetch layout, so import rebuilds the identical Geno (the
// producing host ran the same pure function on the same bytes).
struct ExtView {
  const int64_t * row_ext;      // [n_rows] -> ext geno index or -1
  const int32_t * g_longest;    // [n_ext]
  const int64_t * g_poff;       // [n_ext + 1] path ranges
  const int64_t * p_start;      // per path
  const int64_t * p_end;
  const int32_t * p_rsi;
  const int32_t * p_rei;
  const int32_t * p_mm;
  const int64_t * p_soff;       // [n_paths + 1] site ranges
  const int64_t * s_vorder;     // per site
  const int64_t * s_noff;       // [n_sites + 1] num ranges
  const uint16_t * nums;        // sorted unique allele values
  const int64_t * rep_row_fwd;  // [n_reps] row or -1 (prep numbering)
  const int64_t * rep_row_rc;
};

static bool geno_from_ext(const ExtView & E, int64_t row, Geno & g)
{
  if (row < 0)
    return false;
  int64_t e = E.row_ext[row];
  if (e < 0)
    return false;
  g.longest = E.g_longest[e];
  g.paths.reserve((size_t)(E.g_poff[e + 1] - E.g_poff[e]));
  for (int64_t pi = E.g_poff[e]; pi < E.g_poff[e + 1]; ++pi)
  {
    Path p;
    p.start = E.p_start[pi];
    p.end = E.p_end[pi];
    p.rsi = E.p_rsi[pi];
    p.rei = E.p_rei[pi];
    p.mismatches = E.p_mm[pi];
    int64_t s_lo = E.p_soff[pi], s_hi = E.p_soff[pi + 1];
    p.var_order.reserve((size_t)(s_hi - s_lo));
    p.nums.reserve((size_t)(s_hi - s_lo));
    for (int64_t si = s_lo; si < s_hi; ++si)
    {
      p.var_order.push_back(E.s_vorder[si]);
      p.nums.emplace_back(E.nums + E.s_noff[si], E.nums + E.s_noff[si + 1]);
    }
    g.paths.push_back(std::move(p));
  }
  return true;
}

static std::atomic<int64_t> g_dal_clean{0}, g_dal_fallback{0}, g_dal_bad{0};

static bool synth_geno_from_verdict(const GraphView & G, const int32_t * vr, int len, Geno & g)
{
  if ((vr[0] & 1) == 0)
    return false;
  int nv = (vr[0] >> 4) & 15;
  Path p;
  p.start = (int64_t)(uint32_t)vr[1];
  p.end = (int64_t)(uint32_t)vr[2];
  p.rsi = 0;
  p.rei = len - 1;
  p.mismatches = (vr[0] >> 1) & 7;
  if (nv > 0)
  {
    // slots arrive in (kmer asc, label asc) order as var_id | (kmer << 24).
    // Reproduce the lattice's path_merge ordering exactly: fold kmers LAST
    // -> FIRST (later kmers' sites lead the var_order), same-site alleles
    // within one kmer union (merge_with_current), across kmers intersect
    // (path_merge); an empty intersection means the host would split paths,
    // so it falls back.
    int maxk = 0;
    for (int s = 0; s < nv; ++s)
    {
      if (vr[3 + s] < 0)
        return false;
      maxk = std::max(maxk, vr[3 + s] >> 24);
    }
    for (int k = maxk; k >= 0; --k)
    {
      int64_t ko[6];
      std::vector<uint16_t> kn[6];
      int nko = 0;
      for (int s = 0; s < nv; ++s)
      {
        if ((vr[3 + s] >> 24) != k)
          continue;
        int64_t v = vr[3 + s] & 0xFFFFFF;
        if (v >= G.n_var)
          return false;
        int64_t order = G.var_order[v];
        uint16_t num = (uint16_t)G.variant_num(v);
        bool found = false;
        for (int q = 0; q < nko; ++q)
          if (ko[q] == order)
          {
            nums_insert(kn[q], num);
            found = true;
            break;
          }
        if (!found)
        {
          ko[nko] = order;
          kn[nko].assign(1, num);
          ++nko;
        }
      }
      for (int q = 0; q < nko; ++q)
      {
        bool found = false;
        for (size_t w = 0; w < p.var_order.size(); ++w)
          if (p.var_order[w] == ko[q])
          {
            std::vector<uint16_t> inter;
            std::set_intersection(p.nums[w].begin(), p.nums[w].end(), kn[q].begin(),
                                  kn[q].end(), std::back_inserter(inter));
            if (inter.empty())
              return false;
            p.nums[w] = std::move(inter);
            found = true;
            break;
          }
        if (!found)
        {
          p.var_order.push_back(ko[q]);
          p.nums.push_back(std::move(kn[q]));
        }
      }
    }
  }
  g.paths.clear();
  g.paths.push_back(std::move(p));
  g.longest = len;
  return true;
}

static bool geno_equal(const Geno & a, const Geno & b)
{
  if (a.paths.size() != b.paths.size() || a.longest != b.longest)
    return false;
  for (size_t i = 0; i < a.paths.size(); ++i)
  {
    const Path & p = a.paths[i];
    const Path & q = b.paths[i];
    if (p.start != q.start || p.end != q.end || p.rsi != q.rsi || p.rei != q.rei ||
        p.mismatches != q.mismatches || p.var_order != q.var_order || p.nums != q.nums)
      return false;
  }
  return true;
}

static void * run_call_core(
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // pooled reads (already region-filtered + (ref_id,pos,seq)-sorted)
  const uint8_t * read_codes, const int64_t * read_off, int64_t n_reads,
  const uint8_t * names, const int64_t * name_off,
  const int32_t * flags, const int32_t * mapq, const int32_t * tlen,
  const uint8_t * same_ref, const int64_t * pos,
  const int32_t * score_diff, const int32_t * clipped_count,
  const uint8_t * quals, const int64_t * qual_off,
  const int32_t * rg_idx,
  // options
  int32_t n_samples, int32_t sam_flag_filter, int32_t force_both, int32_t hq_reads,
  int32_t n_threads,
  // precomputed dedup (optional; both or neither) and seed candidates
  const int64_t * reps_in, int64_t n_reps_in, const int64_t * rep_of_in,
  const CandView * cand, const SeedFilter * sf, const VerdView * verd,
  // externally-computed rep results (rep-sharded distributed; nullable)
  const ExtView * ext,
  // SV mode (nullable): is_good_sv_read verdicts + coverage bins + depth
  const SvCtx * sv,
  // out sizes
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  GraphView G{ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
              var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
              sp_ref_reach, sp_actual, n_special, sv != nullptr};
  IndexView I{keys, n_keys, offsets, lab_start, lab_end, lab_var};
  SiteView S{site_order, site_cnum, site_is_snp, n_sites};

  CallResult * R = new CallResult();
  R->eps_sum.assign(n_sites * n_samples, 0);
  int64_t prof_t0 = prof_enabled() ? prof_now() : 0;

  // ---- stage 1: align representatives of each (pos, seq) run -------------
  // SV mode always computes its own reps: the is_good_sv_read gate and the
  // coverage bins (decided here, metadata-only, exactly replaying the
  // Python loop order) change which reads get aligned at all.
  std::vector<int64_t> reps_own, rep_of_own;
  std::vector<uint8_t> skip;  // SV: new-key reads rejected by their bin
  bool cov_filter = sv != nullptr && sv->avg_cov != nullptr;
  if (reps_in == nullptr || sv != nullptr)
  {
    verd = nullptr;  // verdict rows are indexed by the PREP's rep ids
    ext = nullptr;   // ext rows likewise
  }
  if (reps_in == nullptr || sv != nullptr)
  {
    rep_of_own.assign(n_reads, -1);
    if (sv != nullptr)
      skip.assign(n_reads, 0);
    std::vector<std::unordered_map<int64_t, int32_t>> bins(cov_filter ? n_samples : 0);
    auto bin_update = [&](int32_t s, int64_t p) -> bool {
      // hts_parallel_reader.cpp:599-633 — 50bp bins capped at 3x coverage
      double ac = sv->avg_cov[s];
      if (ac <= 0.0)
        return true;
      int64_t max_bin = std::min<int64_t>(0xFFFF, (int64_t)(ac * 50.0 * 3.0 + 0.5));
      int64_t b = (p - sv->first_pos) / 50;
      int32_t & cnt = bins[s][b];
      if (cnt > max_bin)
        return false;
      cnt += 1;
      return true;
    };
    int64_t prev = -1;
    for (int64_t r = 0; r < n_reads; ++r)
    {
      if (flags[r] & sam_flag_filter)
        continue;
      if (sv != nullptr && sv->sv_bad[r])
        continue;
      bool same = prev >= 0 && pos[r] == pos[prev] &&
                  (read_off[r + 1] - read_off[r]) == (read_off[prev + 1] - read_off[prev]) &&
                  memcmp(read_codes + read_off[r], read_codes + read_off[prev],
                         read_off[r + 1] - read_off[r]) == 0;
      if (same)
      {
        if (cov_filter)
          bin_update(rg_idx[r], pos[r]);  // duplicates update, never reject
        rep_of_own[r] = (int64_t)reps_own.size() - 1;
        continue;
      }
      if (cov_filter && !bin_update(rg_idx[r], pos[r]))
      {
        skip[r] = 1;  // prev unchanged, like Python's prev_key
        continue;
      }
      reps_own.push_back(r);
      prev = r;
      rep_of_own[r] = (int64_t)reps_own.size() - 1;
    }
    reps_in = reps_own.data();
    n_reps_in = (int64_t)reps_own.size();
    rep_of_in = rep_of_own.data();
  }
  struct RepsView {
    const int64_t * d;
    int64_t n;
    int64_t operator[](size_t i) const { return d[i]; }
    size_t size() const { return (size_t)n; }
  };
  RepsView reps{reps_in, n_reps_in};
  const int64_t * rep_of = rep_of_in;

  std::vector<std::pair<Geno, Geno>> aligned(reps.size());
  {
    auto align_range = [&](size_t lo, size_t hi) {
      std::vector<uint8_t> rcodes;
      std::vector<int64_t> ids1, ids2;
      for (size_t q = lo; q < hi; ++q)
      {
        int64_t r = reps[q];
        const uint8_t * codes = read_codes + read_off[r];
        int len = (int)(read_off[r + 1] - read_off[r]);
        Geno & g1 = aligned[q].first;
        Geno & g2 = aligned[q].second;
        g1.read_length = g2.read_length = len;
        if (len >= 2 * K - 1)
        {
          bool proper_geometry =
            (flags[r] & IS_PAIRED) == 0 ||
            (same_ref[r] && -1200 < tlen[r] && tlen[r] < 1200 &&
             ((flags[r] & 0x10) != 0) != ((flags[r] & 0x20) != 0));
          SeedCands sc1, sc2;
          const SeedCands * c1 = nullptr;
          const SeedCands * c2 = nullptr;
          if (cand != nullptr)
          {
            cand->collect(cand->rep_row_fwd[q], ids1);
            sc1 = {ids1.data(), ids1.data() + ids1.size(), 0};
            c1 = &sc1;
            int64_t row2 = cand->rep_row_rc[q];
            if (row2 >= 0)
            {
              cand->collect(row2, ids2);
              sc2 = {ids2.data(), ids2.data() + ids2.size(), 0};
              c2 = &sc2;
            }
          }
          // device-verdict fast path: clean rows skip seed+lattice+walk
          auto try_device = [&](int64_t row, const uint8_t * cp, Geno & g) -> bool {
            if (verd == nullptr || row < 0)
              return false;
            if (!synth_geno_from_verdict(G, verd->rows + row * VERD_COLS, len, g))
            {
              g_dal_fallback.fetch_add(1, std::memory_order_relaxed);
              return false;
            }
            if (verd->verify)
            {
              Geno ref;
              ref.read_length = len;
              find_genotype_paths(G, I, cp, len, ref, nullptr, sf);
              if (!geno_equal(g, ref))
              {
                g_dal_bad.fetch_add(1, std::memory_order_relaxed);
                g = std::move(ref);  // host result wins: correctness preserved
                return true;
              }
            }
            g_dal_clean.fetch_add(1, std::memory_order_relaxed);
            return true;
          };
          if (!(ext != nullptr && geno_from_ext(*ext, ext->rep_row_fwd[q], g1)) &&
              !try_device(verd != nullptr ? verd->rep_row_fwd[q] : -1, codes, g1))
            find_genotype_paths(G, I, codes, len, g1, c1, sf);
          if (!proper_geometry || force_both)
          {
            if (ext != nullptr && geno_from_ext(*ext, ext->rep_row_rc[q], g2))
              continue;
            rcodes.resize(len);
            for (int i = 0; i < len; ++i)
              rcodes[i] = CODE_COMP[codes[len - 1 - i] & 15];
            if (!try_device(verd != nullptr ? verd->rep_row_rc[q] : -1, rcodes.data(), g2))
              find_genotype_paths(G, I, rcodes.data(), len, g2, c2, sf);
          }
        }
      }
    };
    int nt = (n_threads <= 1) ? 1 : std::min<int64_t>(n_threads, ((int64_t)reps.size() + 63) / 64);
    if (nt <= 1)
      align_range(0, reps.size());
    else
    {
      std::vector<std::thread> threads;
      size_t per = (reps.size() + nt - 1) / nt;
      for (int t = 0; t < nt; ++t)
      {
        size_t lo = t * per, hi = std::min(reps.size(), (t + 1) * per);
        if (lo >= hi)
          break;
        threads.emplace_back(align_range, lo, hi);
      }
      for (auto & th : threads)
        th.join();
    }
  }

  int64_t prof_t1 = prof_enabled() ? prof_now() : 0;

  // ---- stage 2: pooled loop, parallel over samples -----------------------
  // Per-(site,sample) scoring state, pair-pending maps and phasing
  // connections are all sample-local, so workers own disjoint sample ranges
  // and each replays the pool stream in order for its own samples. Results
  // merge deterministically (worker order; the conn maps are ordered and
  // sample-disjoint), and per-sample read order is unchanged, so the
  // saturation mask and all sums match the serial walk exactly.
  for (int64_t r = 0; r < n_reads; ++r)
  {
    if (flags[r] & sam_flag_filter)
      continue;
    if (sv != nullptr && (sv->sv_bad[r] || skip[r]))
      continue;
    R->num_records += 1;
    int64_t rep = rep_of[r];
    if (rep >= 0 && reps[rep] != r)
      R->num_duplicated += 1;
  }

  auto stage2_range = [&](int32_t slo, int32_t shi, CallResult & Rw) {
    CallCtx Cw{&G, &S, n_samples, hq_reads != 0, &Rw, sv};
    std::vector<std::unordered_map<std::string, Pending>> maps(shi - slo);
    int64_t ins_counter = 0;
    for (int64_t r = 0; r < n_reads; ++r)
    {
      if (flags[r] & sam_flag_filter)
        continue;
      if (sv != nullptr && (sv->sv_bad[r] || skip[r]))
        continue;
      int32_t rg = rg_idx[r];
      if (rg < slo || rg >= shi)
        continue;
      int64_t rep = rep_of[r];
      std::string name((const char *)(names + name_off[r]),
                       (size_t)(name_off[r + 1] - name_off[r]));
      int32_t qlen = (int32_t)(qual_off[r + 1] - qual_off[r]);
      if (!stage2_one_record(Cw, rg, (uint32_t)flags[r], mapq[r], clipped_count[r],
                             score_diff[r], quals + qual_off[r], qlen, std::move(name),
                             aligned[rep].first, aligned[rep].second, maps[rg - slo],
                             sv != nullptr ? &ins_counter : nullptr))
      {
        Rw.error = 1;  // both mates claim the same pair slot; Python raises
        break;
      }
    }
    // SV keeps unmatched mates (caller.py:436-447), in map insertion order
    // (Python dict order); per-sample, in sample order like the Python loop
    if (sv != nullptr && !Rw.error)
    {
      for (int32_t rg = slo; rg < shi; ++rg)
      {
        auto & map = maps[rg - slo];
        std::vector<const Pending *> order;
        order.reserve(map.size());
        for (auto const & kv : map)
          order.push_back(&kv.second);
        std::sort(order.begin(), order.end(),
                  [](const Pending * a, const Pending * b) { return a->ins_seq < b->ins_seq; });
        for (const Pending * p : order)
          process_leftover_mate(Cw, *p, rg);
      }
    }
  };

  {
    int nt = (n_threads <= 1) ? 1 : std::min<int32_t>(n_threads, n_samples);
    if (nt <= 1)
      stage2_range(0, n_samples, *R);
    else
    {
      std::vector<CallResult> parts(nt);
      std::vector<std::thread> threads;
      int per = (n_samples + nt - 1) / nt;
      std::vector<std::pair<int32_t, int32_t>> ranges;
      for (int t = 0; t < nt; ++t)
      {
        int32_t slo = t * per, shi = std::min<int32_t>(n_samples, (t + 1) * per);
        if (slo >= shi)
          break;
        parts[ranges.size()].eps_sum.assign(n_sites * n_samples, 0);
        threads.emplace_back([&, slo, shi, ti = ranges.size()]() { stage2_range(slo, shi, parts[ti]); });
        ranges.push_back({slo, shi});
      }
      for (auto & th : threads)
        th.join();
      merge_worker_parts(R, parts, ranges, n_sites, n_samples);
    }
  }

  if (prof_enabled())
  {
    int64_t prof_t2 = prof_now();
    fprintf(stderr,
            "[gt_native] reads=%lld reps=%lld stage1=%.3fs stage2=%.3fs "
            "(thread-sum: seed=%.3fs lattice=%.3fs walk=%.3fs)\n",
            (long long)n_reads, (long long)reps.size(), (prof_t1 - prof_t0) * 1e-9,
            (prof_t2 - prof_t1) * 1e-9, prof_seed_ns.load() * 1e-9,
            prof_lattice_ns.load() * 1e-9, prof_walk_ns.load() * 1e-9);
    prof_seed_ns = 0;
    prof_lattice_ns = 0;
    prof_walk_ns = 0;
  }

  R->finalize_conn();
  *out_n_obs = (int64_t)R->o_site.size();
  *out_n_xvals = (int64_t)R->x_vals.size();
  *out_n_conn = (int64_t)R->c_hap1.size();
  *out_n_counts = (int64_t)R->c_counts.size();
  *out_n_touched = (int64_t)R->t_hap1.size();
  return R;
}

void * gt_call_pool(
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // pooled reads (already region-filtered + (ref_id,pos,seq)-sorted)
  const uint8_t * read_codes, const int64_t * read_off, int64_t n_reads,
  const uint8_t * names, const int64_t * name_off,
  const int32_t * flags, const int32_t * mapq, const int32_t * tlen,
  const uint8_t * same_ref, const int64_t * pos,
  const int32_t * score_diff, const int32_t * clipped_count,
  const uint8_t * quals, const int64_t * qual_off,
  const int32_t * rg_idx,
  // options
  int32_t n_samples, int32_t sam_flag_filter, int32_t force_both, int32_t hq_reads,
  int32_t n_threads,
  // optional seed filter handle from gt_seed_filter_build (nullable)
  void * seed_filter,
  // out sizes
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  return run_call_core(
    ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
    var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
    sp_ref_reach, sp_actual, n_special,
    site_order, site_cnum, site_is_snp, n_sites,
    keys, n_keys, offsets, lab_start, lab_end, lab_var,
    read_codes, read_off, n_reads, names, name_off,
    flags, mapq, tlen, same_ref, pos, score_diff, clipped_count,
    quals, qual_off, rg_idx,
    n_samples, sam_flag_filter, force_both, hq_reads, n_threads,
    nullptr, 0, nullptr, nullptr, (const SeedFilter *)seed_filter, nullptr, nullptr, nullptr,
    out_n_obs, out_n_xvals, out_n_conn, out_n_counts, out_n_touched);
}

// SV-mode pooled caller (pipeline/caller.py call_pool is_sv branches): the
// same loop with the is_good_sv_read gate, 50bp/3x coverage bins, SV path
// goodness tier, leftover-mate resolution, and ReferenceDepth accumulation.
void * gt_call_pool_sv(
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // pooled reads (already region-filtered + (ref_id,pos,seq)-sorted)
  const uint8_t * read_codes, const int64_t * read_off, int64_t n_reads,
  const uint8_t * names, const int64_t * name_off,
  const int32_t * flags, const int32_t * mapq, const int32_t * tlen,
  const uint8_t * same_ref, const int64_t * pos,
  const int32_t * score_diff, const int32_t * clipped_count,
  const uint8_t * quals, const int64_t * qual_off,
  const int32_t * rg_idx,
  // options
  int32_t n_samples, int32_t sam_flag_filter, int32_t force_both, int32_t hq_reads,
  int32_t n_threads,
  // optional seed filter handle from gt_seed_filter_build (nullable)
  void * seed_filter,
  // SV inputs: per-read is_good_sv_read verdicts, the coverage filter
  // (nullable avg_cov disables it), and the depth track to fill
  const uint8_t * sv_bad, const double * avg_cov, int64_t first_pos,
  int32_t * depth, int64_t ref_size, int64_t ref_offset,
  // out sizes
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  SvCtx sv{sv_bad, avg_cov, first_pos, depth, ref_size, ref_offset};
  return run_call_core(
    ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
    var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
    sp_ref_reach, sp_actual, n_special,
    site_order, site_cnum, site_is_snp, n_sites,
    keys, n_keys, offsets, lab_start, lab_end, lab_var,
    read_codes, read_off, n_reads, names, name_off,
    flags, mapq, tlen, same_ref, pos, score_diff, clipped_count,
    quals, qual_off, rg_idx,
    n_samples, sam_flag_filter, force_both, hq_reads, n_threads,
    nullptr, 0, nullptr, nullptr, (const SeedFilter *)seed_filter, nullptr, nullptr, &sv,
    out_n_obs, out_n_xvals, out_n_conn, out_n_counts, out_n_touched);
}

int32_t gt_call_pool_fetch(void * handle,
                           int32_t * o_site, int32_t * o_sample, int32_t * o_eps,
                           uint8_t * o_apply, uint32_t * o_bits_lo, uint32_t * o_bits_hi,
                           int32_t * o_cov, int32_t * o_clip_scaled, uint8_t * o_clip_flag,
                           int32_t * o_mapq_sq, int32_t * o_mm_scaled, int32_t * o_sdiff,
                           uint8_t * o_strand, uint8_t * o_proper, uint8_t * o_big,
                           int32_t * x_count, uint16_t * x_vals,
                           int64_t * c_hap1, int32_t * c_pn, int32_t * c_b1, int64_t * c_hap2,
                           int32_t * c_ncounts, int64_t * c_counts,
                           int64_t * t_hap1, int32_t * t_pn, int32_t * t_b1,
                           int64_t * eps_sum, int64_t * stats_out)
{
  CallResult * R = static_cast<CallResult *>(handle);
  if (!R)
    return -1;
  if (R->error)
    return R->error;
  auto cp = [](auto * dst, auto const & src) {
    memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(o_site, R->o_site);
  cp(o_sample, R->o_sample);
  cp(o_eps, R->o_eps);
  cp(o_apply, R->o_apply);
  cp(o_bits_lo, R->o_bits_lo);
  cp(o_bits_hi, R->o_bits_hi);
  cp(o_cov, R->o_cov);
  cp(o_clip_scaled, R->o_clip_scaled);
  cp(o_clip_flag, R->o_clip_flag);
  cp(o_mapq_sq, R->o_mapq_sq);
  cp(o_mm_scaled, R->o_mm_scaled);
  cp(o_sdiff, R->o_sdiff);
  cp(o_strand, R->o_strand);
  cp(o_proper, R->o_proper);
  cp(o_big, R->o_big);
  cp(x_count, R->x_count);
  cp(x_vals, R->x_vals);
  cp(c_hap1, R->c_hap1);
  cp(c_pn, R->c_pn);
  cp(c_b1, R->c_b1);
  cp(c_hap2, R->c_hap2);
  cp(c_ncounts, R->c_ncounts);
  cp(c_counts, R->c_counts);
  cp(t_hap1, R->t_hap1);
  cp(t_pn, R->t_pn);
  cp(t_b1, R->t_b1);
  cp(eps_sum, R->eps_sum);
  stats_out[0] = R->num_records;
  stats_out[1] = R->num_duplicated;
  return 0;
}

void gt_call_pool_free(void * handle)
{
  delete static_cast<CallResult *>(handle);
}

// ---------------------------------------------------------------------------
// Array-native entry: parse pool BAM bytes directly (no Python record
// objects), pool-sort by (ref_id, pos, seq), and run the same caller loop.
// ---------------------------------------------------------------------------

// A parsed, pool-sorted, dedup-computed batch of BAM records: everything
// the caller stages need that does NOT depend on the graph/index. Built
// once per pool and reused across call iterations (the graph changes, the
// reads do not) — and it owns the device-facing read-sequence matrix (one
// row per rep orientation that stage 1 will align).
struct PrepPool {
  std::vector<uint8_t> read_codes, names, quals, same_ref;
  std::vector<int64_t> read_off, name_off, qual_off, pos;
  std::vector<int32_t> flags, mapq, tlen, sdiff, clip, rg;
  std::vector<uint8_t> sv_bad;  // is_good_sv_read verdicts (SV pools)
  int64_t n_reads = 0;
  int32_t sam_flag_filter = 0, force_both = 0;
  // dedup
  std::vector<int64_t> reps, rep_of;
  // device rows
  std::vector<int64_t> rep_row_fwd, rep_row_rc;  // [n_reps] row or -1
  std::vector<int64_t> row_rep;                  // row -> rep
  std::vector<uint8_t> row_is_rc;
  int32_t row_len = 0;  // max rep read length
};

static void compute_reps_rows(PrepPool & P)
{
  P.rep_of.assign(P.n_reads, -1);
  int64_t prev = -1;
  for (int64_t r = 0; r < P.n_reads; ++r)
  {
    if (P.flags[r] & P.sam_flag_filter)
      continue;
    bool same = prev >= 0 && P.pos[r] == P.pos[prev] &&
                (P.read_off[r + 1] - P.read_off[r]) == (P.read_off[prev + 1] - P.read_off[prev]) &&
                memcmp(P.read_codes.data() + P.read_off[r], P.read_codes.data() + P.read_off[prev],
                       P.read_off[r + 1] - P.read_off[r]) == 0;
    if (!same)
    {
      P.reps.push_back(r);
      prev = r;
    }
    P.rep_of[r] = (int64_t)P.reps.size() - 1;
  }
  int64_t n_reps = (int64_t)P.reps.size();
  P.rep_row_fwd.assign(n_reps, -1);
  P.rep_row_rc.assign(n_reps, -1);
  P.row_len = 0;
  for (int64_t q = 0; q < n_reps; ++q)
  {
    int64_t r = P.reps[q];
    int len = (int)(P.read_off[r + 1] - P.read_off[r]);
    if (len < 2 * K - 1)
      continue;
    if (len > P.row_len)
      P.row_len = len;
    P.rep_row_fwd[q] = (int64_t)P.row_rep.size();
    P.row_rep.push_back(q);
    P.row_is_rc.push_back(0);
    bool proper_geometry =
      (P.flags[r] & IS_PAIRED) == 0 ||
      (P.same_ref[r] && -1200 < P.tlen[r] && P.tlen[r] < 1200 &&
       ((P.flags[r] & 0x10) != 0) != ((P.flags[r] & 0x20) != 0));
    if (!proper_geometry || P.force_both)
    {
      P.rep_row_rc[q] = (int64_t)P.row_rep.size();
      P.row_rep.push_back(q);
      P.row_is_rc.push_back(1);
    }
  }
}

static void parse_bam_pool(
  const uint8_t ** file_data, const int64_t * file_size,
  const int64_t * file_target_ref, const int32_t * file_sample_idx, int64_t n_files,
  PrepPool & P,
  // optional position filter: keep only records overlapping [begin, end) on
  // the target contig (htslib bam_endpos semantics: empty-cigar records span
  // one base). begin < 0 disables (keep every target-contig record). This is
  // the record-set definition for SV pools — the reference reads SV regions
  // through index iterators (genotype_sv.cpp) instead of whole contigs, and
  // the BAI/CRAI slice in native_caller._bam_bytes is just an IO shortcut to
  // the same set.
  int64_t filter_begin = -1, int64_t filter_end = -1,
  // cohort pools parse per-file concurrently (record order is preserved:
  // per-file vectors concatenate in file order before the stable sort)
  int32_t n_threads = 1)
{
  // ASCII -> code, matching utils/dna.py _CODE (BAM nibble chars only need
  // "=ACMGRSVTWYHKDBN", but cover the full IUPAC set like the table)
  static uint8_t CODE[256];
  static bool init = false;
  if (!init)
  {
    for (int i = 0; i < 256; ++i)
      CODE[i] = 4;
    const char * bases = "ACGT";
    for (int i = 0; i < 4; ++i)
    {
      CODE[(uint8_t)bases[i]] = i;
      CODE[(uint8_t)(bases[i] + 32)] = i;
    }
    CODE[(uint8_t)'U'] = CODE[(uint8_t)'u'] = 3;
    const char * iupac = "NRYSWKMBDHV";
    for (int i = 0; iupac[i]; ++i)
    {
      CODE[(uint8_t)iupac[i]] = 4 + i;
      CODE[(uint8_t)(iupac[i] + 32)] = 4 + i;
    }
    init = true;
  }

  struct PRead {
    int32_t ref_id;
    int64_t pos;
    const uint8_t * rec;  // record body (after block_size)
    int32_t block_size;
    int32_t sample;
    std::string seq_ascii;
  };

  auto parse_one_file = [&](int64_t f, std::vector<PRead> & out) {
    const uint8_t * data = file_data[f];
    int64_t size = file_size[f];
    if (size < 12 || memcmp(data, "BAM\1", 4) != 0)
      return;
    int32_t l_text;
    memcpy(&l_text, data + 4, 4);
    int64_t off = 8 + l_text;
    int32_t nref;
    memcpy(&nref, data + off, 4);
    off += 4;
    for (int32_t i = 0; i < nref; ++i)
    {
      int32_t l_name;
      memcpy(&l_name, data + off, 4);
      off += 4 + l_name + 4;
    }
    while (off + 4 <= size)
    {
      int32_t block_size;
      memcpy(&block_size, data + off, 4);
      if (block_size <= 0 || off + 4 + block_size > size)
        break;
      const uint8_t * p = data + off + 4;
      int32_t ref_id, pos;
      memcpy(&ref_id, p, 4);
      memcpy(&pos, p + 4, 4);
      if (ref_id >= 0 && ref_id == file_target_ref[f])
      {
        if (filter_begin >= 0)
        {
          uint8_t l_rn = p[8];
          uint16_t nc;
          memcpy(&nc, p + 12, 2);
          int64_t span = 0;
          const uint8_t * cg = p + 32 + l_rn;
          for (uint16_t ci = 0; ci < nc; ++ci)
          {
            uint32_t c;
            memcpy(&c, cg + 4 * ci, 4);
            uint32_t op = c & 0xF;
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)  // M D N = X
              span += c >> 4;
          }
          if (span == 0)
            span = 1;  // bam_endpos: unmapped/cigarless records span 1 base
          if (!(pos < filter_end && pos + span > filter_begin))
          {
            off += 4 + block_size;
            continue;
          }
        }
        PRead pr;
        pr.ref_id = ref_id;
        pr.pos = pos;
        pr.rec = p;
        pr.block_size = block_size;
        pr.sample = file_sample_idx[f];
        // decode seq to ASCII for the pool sort / dedup key
        uint8_t l_read_name = p[8];
        uint16_t n_cigar;
        memcpy(&n_cigar, p + 12, 2);
        int32_t l_seq;
        memcpy(&l_seq, p + 16, 4);
        const uint8_t * s = p + 32 + l_read_name + 4 * n_cigar;
        pr.seq_ascii.resize(l_seq);
        static const char NIB[17] = "=ACMGRSVTWYHKDBN";
        for (int i = 0; i < l_seq; ++i)
          pr.seq_ascii[i] = NIB[(i % 2 == 0) ? (s[i / 2] >> 4) : (s[i / 2] & 0xF)];
        out.push_back(std::move(pr));
      }
      off += 4 + block_size;
    }
  };

  std::vector<std::vector<PRead>> per_file(n_files);
  if (n_threads > 1 && n_files > 1)
  {
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
      for (;;)
      {
        int64_t f = next.fetch_add(1);
        if (f >= n_files)
          break;
        parse_one_file(f, per_file[f]);
      }
    };
    int nt = (int)std::min<int64_t>(n_threads, n_files);
    std::vector<std::thread> ts;
    for (int t = 1; t < nt; ++t)
      ts.emplace_back(worker);
    worker();
    for (auto & t : ts)
      t.join();
  }
  else
  {
    for (int64_t f = 0; f < n_files; ++f)
      parse_one_file(f, per_file[f]);
  }
  std::vector<PRead> pooled;
  {
    size_t total = 0;
    for (auto & v : per_file)
      total += v.size();
    pooled.reserve(total);
    for (auto & v : per_file)  // file order preserved before the stable sort
      for (auto & pr : v)
        pooled.push_back(std::move(pr));
  }

  std::stable_sort(pooled.begin(), pooled.end(), [](const PRead & a, const PRead & b) {
    if (a.ref_id != b.ref_id)
      return a.ref_id < b.ref_id;
    if (a.pos != b.pos)
      return a.pos < b.pos;
    return a.seq_ascii < b.seq_ascii;
  });

  // flatten into the array layout of run_call_core
  int64_t n = (int64_t)pooled.size();
  P.n_reads = n;
  std::vector<uint8_t> & read_codes = P.read_codes;
  std::vector<uint8_t> & names = P.names;
  std::vector<uint8_t> & quals = P.quals;
  P.read_off.assign(n + 1, 0);
  P.name_off.assign(n + 1, 0);
  P.qual_off.assign(n + 1, 0);
  P.pos.assign(n, 0);
  P.flags.assign(n, 0);
  P.mapq.assign(n, 0);
  P.tlen.assign(n, 0);
  P.sdiff.assign(n, 0);
  P.clip.assign(n, 0);
  P.rg.assign(n, 0);
  P.same_ref.assign(n, 0);
  P.sv_bad.assign(n, 0);
  std::vector<int64_t> & read_off = P.read_off;
  std::vector<int64_t> & name_off = P.name_off;
  std::vector<int64_t> & qual_off = P.qual_off;
  std::vector<int64_t> & pos_v = P.pos;
  std::vector<int32_t> & flags_v = P.flags;
  std::vector<int32_t> & mapq_v = P.mapq;
  std::vector<int32_t> & tlen_v = P.tlen;
  std::vector<int32_t> & sdiff_v = P.sdiff;
  std::vector<int32_t> & clip_v = P.clip;
  std::vector<int32_t> & rg_v = P.rg;
  std::vector<uint8_t> & same_ref_v = P.same_ref;

  for (int64_t r = 0; r < n; ++r)
  {
    const PRead & pr = pooled[r];
    const uint8_t * p = pr.rec;
    uint8_t l_read_name = p[8];
    uint8_t mapq8 = p[9];
    uint16_t n_cigar, flag16;
    memcpy(&n_cigar, p + 12, 2);
    memcpy(&flag16, p + 14, 2);
    int32_t l_seq, next_ref, next_pos, tl;
    memcpy(&l_seq, p + 16, 4);
    memcpy(&next_ref, p + 20, 4);
    memcpy(&next_pos, p + 24, 4);
    memcpy(&tl, p + 28, 4);
    pos_v[r] = pr.pos;
    flags_v[r] = flag16;
    mapq_v[r] = mapq8;
    tlen_v[r] = tl;
    same_ref_v[r] = (pr.ref_id == next_ref) ? 1 : 0;
    rg_v[r] = pr.sample;

    const uint8_t * q = p + 32;
    names.insert(names.end(), q, q + l_read_name - 1);
    name_off[r + 1] = (int64_t)names.size();
    q += l_read_name;
    // clipped count (alignment.py _clipped_count): front S count, else back
    int32_t clip = 0;
    if (n_cigar > 0)
    {
      uint32_t c0, cl;
      memcpy(&c0, q, 4);
      memcpy(&cl, q + 4 * (n_cigar - 1), 4);
      if ((c0 & 0xF) == 4)
        clip = (int32_t)(c0 >> 4);
      else if ((cl & 0xF) == 4)
        clip = (int32_t)(cl >> 4);
    }
    clip_v[r] = clip;
    // is_good_sv_read (caller.py:79-93, hts_parallel_reader.cpp:528-568)
    {
      bool bad = false;
      if (flag16 & 0x4)  // IS_UNMAPPED
        bad = true;
      else
      {
        bool far = pr.ref_id != next_ref ||
                   (pr.pos > next_pos ? pr.pos - next_pos : next_pos - pr.pos) > 200000;
        if (mapq8 <= 15 && far)
          bad = true;
        else if (n_cigar >= 2)
        {
          uint32_t c0, cl;
          memcpy(&c0, q, 4);
          memcpy(&cl, q + 4 * (n_cigar - 1), 4);
          bool front_s = (c0 & 0xF) == 4, back_s = (cl & 0xF) == 4;
          bool one_clipped = (front_s && (c0 >> 4) >= 12) || (back_s && (cl >> 4) >= 12);
          if ((front_s && back_s) || (mapq8 <= 15 && one_clipped))
            bad = true;
        }
      }
      P.sv_bad[r] = bad ? 1 : 0;
    }
    q += 4 * n_cigar;
    for (char ch : pr.seq_ascii)
      read_codes.push_back(CODE[(uint8_t)ch]);
    read_off[r + 1] = (int64_t)read_codes.size();
    q += (l_seq + 1) / 2;
    quals.insert(quals.end(), q, q + l_seq);
    qual_off[r + 1] = (int64_t)quals.size();
    q += l_seq;

    // AS/XS tags -> score_diff (alignment.py _score_diff)
    const uint8_t * end = p + pr.block_size;
    int64_t as_ = -1, xs = -1;
    while (q + 3 <= end)
    {
      char t0 = q[0], t1 = q[1], typ = q[2];
      q += 3;
      int64_t val = 0;
      int adv = 0;
      switch (typ)
      {
      case 'A': val = q[0]; adv = 1; break;
      case 'c': val = (int8_t)q[0]; adv = 1; break;
      case 'C': val = q[0]; adv = 1; break;
      case 's': { int16_t v; memcpy(&v, q, 2); val = v; adv = 2; break; }
      case 'S': { uint16_t v; memcpy(&v, q, 2); val = v; adv = 2; break; }
      case 'i': { int32_t v; memcpy(&v, q, 4); val = v; adv = 4; break; }
      case 'I': { uint32_t v; memcpy(&v, q, 4); val = v; adv = 4; break; }
      case 'f': adv = 4; break;
      case 'Z': case 'H': {
        const uint8_t * z = q;
        while (z < end && *z) ++z;
        adv = (int)(z - q) + 1;
        break;
      }
      case 'B': {
        char sub = (char)q[0];
        uint32_t cnt;
        memcpy(&cnt, q + 1, 4);
        int es = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        adv = 5 + es * (int)cnt;
        break;
      }
      default: adv = (int)(end - q); break;
      }
      if (t0 == 'A' && t1 == 'S') as_ = val;
      if (t0 == 'X' && t1 == 'S') xs = val;
      q += adv;
    }
    int64_t sd = 0;
    if (!(as_ == -1 || as_ < xs))
    {
      if (xs == -1)
        xs = 0;
      sd = std::min<int64_t>(as_ - xs, 255);
    }
    sdiff_v[r] = (int32_t)sd;
  }

}

// Shared tail: run the caller stages over a PrepPool with the given graph.
static void * finish_from_prep(
  const PrepPool & P,
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  int32_t n_samples, int32_t hq_reads, int32_t n_threads,
  const CandView * cand, const SeedFilter * sf, const VerdView * verd, const ExtView * ext,
  const SvCtx * sv,
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  return run_call_core(
    ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
    var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
    sp_ref_reach, sp_actual, n_special,
    site_order, site_cnum, site_is_snp, n_sites,
    keys, n_keys, offsets, lab_start, lab_end, lab_var,
    P.read_codes.data(), P.read_off.data(), P.n_reads,
    P.names.data(), P.name_off.data(),
    P.flags.data(), P.mapq.data(), P.tlen.data(), P.same_ref.data(), P.pos.data(),
    P.sdiff.data(), P.clip.data(),
    P.quals.data(), P.qual_off.data(),
    P.rg.data(),
    n_samples, P.sam_flag_filter, P.force_both, hq_reads, n_threads,
    P.reps.data(), (int64_t)P.reps.size(), P.rep_of.data(), cand, sf, verd, ext, sv,
    out_n_obs, out_n_xvals, out_n_conn, out_n_counts, out_n_touched);
}

void * gt_call_pool_bam(
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // pool files: decompressed BAM bytes per file
  const uint8_t ** file_data, const int64_t * file_size,
  const int64_t * file_target_ref, const int32_t * file_sample_idx, int64_t n_files,
  // options
  int32_t n_samples, int32_t sam_flag_filter, int32_t force_both, int32_t hq_reads,
  int32_t n_threads,
  // optional seed filter handle from gt_seed_filter_build (nullable)
  void * seed_filter,
  // out sizes
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  PrepPool P;
  P.sam_flag_filter = sam_flag_filter;
  P.force_both = force_both;
  parse_bam_pool(file_data, file_size, file_target_ref, file_sample_idx, n_files, P,
                 -1, -1, n_threads);
  compute_reps_rows(P);
  return finish_from_prep(
    P,
    ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
    var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
    sp_ref_reach, sp_actual, n_special,
    site_order, site_cnum, site_is_snp, n_sites,
    keys, n_keys, offsets, lab_start, lab_end, lab_var,
    n_samples, hq_reads, n_threads, nullptr, (const SeedFilter *)seed_filter, nullptr, nullptr, nullptr,
    out_n_obs, out_n_xvals, out_n_conn, out_n_counts, out_n_touched);
}

// ---- prepare/finish split: parse once, call per iteration ----------------

void * gt_call_prepare_bam(
  const uint8_t ** file_data, const int64_t * file_size,
  const int64_t * file_target_ref, const int32_t * file_sample_idx, int64_t n_files,
  int32_t sam_flag_filter, int32_t force_both,
  // position filter: keep records overlapping [begin, end); begin < 0 = off
  int64_t filter_begin, int64_t filter_end,
  int32_t n_threads,
  int64_t * out_n_reads, int64_t * out_n_rows, int32_t * out_row_len)
{
  PrepPool * P = new PrepPool();
  P->sam_flag_filter = sam_flag_filter;
  P->force_both = force_both;
  parse_bam_pool(file_data, file_size, file_target_ref, file_sample_idx, n_files, *P,
                 filter_begin, filter_end, n_threads);
  compute_reps_rows(*P);
  *out_n_reads = P->n_reads;
  *out_n_rows = (int64_t)P->row_rep.size();
  *out_row_len = P->row_len;
  return P;
}

// Fill the device read-sequence matrix: codes_out is [n_rows, row_len]
// (pad code 15, rejected by both kmers and walks), lens_out is [n_rows].
void gt_prep_fetch_seqs(void * prep, uint8_t * codes_out, int32_t * lens_out)
{
  PrepPool * P = (PrepPool *)prep;
  int64_t n_rows = (int64_t)P->row_rep.size();
  int32_t L = P->row_len;
  for (int64_t row = 0; row < n_rows; ++row)
  {
    int64_t r = P->reps[P->row_rep[row]];
    const uint8_t * codes = P->read_codes.data() + P->read_off[r];
    int len = (int)(P->read_off[r + 1] - P->read_off[r]);
    uint8_t * dst = codes_out + row * L;
    if (P->row_is_rc[row])
      for (int i = 0; i < len; ++i)
        dst[i] = CODE_COMP[codes[len - 1 - i] & 15];
    else
      memcpy(dst, codes, len);
    memset(dst + len, 15, L - len);
    lens_out[row] = len;
  }
}

// Fill the device k-mer matrix: the exact seed key of every (row, kpos) as
// (hi, lo) uint32 halves + a validity flag (in-range and unambiguous). The
// device expands each valid key into its 97 probes and tests them against
// the membership bitset; ambiguous kmers stay host-probed. Arrays are
// [n_rows, nk_max] with nk_max = 1 + (row_len - K) / (K - 1).
void gt_prep_fetch_kmers(void * prep, uint32_t * hi_out, uint32_t * lo_out,
                         uint8_t * valid_out)
{
  PrepPool * P = (PrepPool *)prep;
  int64_t n_rows = (int64_t)P->row_rep.size();
  if (P->row_len < K)
    return;
  int64_t nk_max = 1 + (P->row_len - K) / (K - 1);
  std::vector<uint8_t> rcodes;
  for (int64_t row = 0; row < n_rows; ++row)
  {
    int64_t r = P->reps[P->row_rep[row]];
    const uint8_t * codes = P->read_codes.data() + P->read_off[r];
    int len = (int)(P->read_off[r + 1] - P->read_off[r]);
    if (P->row_is_rc[row])
    {
      rcodes.resize(len);
      for (int i = 0; i < len; ++i)
        rcodes[i] = CODE_COMP[codes[len - 1 - i] & 15];
      codes = rcodes.data();
    }
    for (int64_t i = 0; i < nk_max; ++i)
    {
      int64_t p = (K - 1) * i;
      int64_t o = row * nk_max + i;
      if (p + K > len)
      {
        hi_out[o] = lo_out[o] = 0;
        valid_out[o] = 0;
        continue;
      }
      uint64_t key = 0;
      bool amb = false;
      for (int64_t j = p; j < p + K; ++j)
      {
        if (codes[j] >= 4)
        {
          amb = true;
          break;
        }
        key = (key << 2) | codes[j];
      }
      hi_out[o] = amb ? 0 : (uint32_t)(key >> 32);
      lo_out[o] = amb ? 0 : (uint32_t)key;
      valid_out[o] = amb ? 0 : 1;
    }
  }
}

// Per-row tail matrix for the device aligner: the read bases AFTER the last
// full stride-(K-1) kmer (read index 31*nk_r + 1 ..), padded with 15, plus
// per-row read lengths. TAIL_PAD=32 covers the maximum tail (30: one more
// kmer would fit at 31).
void gt_prep_fetch_tails(void * prep, uint8_t * tails_out, int32_t * lens_out)
{
  PrepPool * P = (PrepPool *)prep;
  int64_t n_rows = (int64_t)P->row_rep.size();
  std::vector<uint8_t> rcodes;
  for (int64_t row = 0; row < n_rows; ++row)
  {
    int64_t r = P->reps[P->row_rep[row]];
    const uint8_t * codes = P->read_codes.data() + P->read_off[r];
    int len = (int)(P->read_off[r + 1] - P->read_off[r]);
    if (P->row_is_rc[row])
    {
      rcodes.resize(len);
      for (int i = 0; i < len; ++i)
        rcodes[i] = CODE_COMP[codes[len - 1 - i] & 15];
      codes = rcodes.data();
    }
    lens_out[row] = len;
    uint8_t * dst = tails_out + row * 32;
    memset(dst, 15, 32);
    if (len >= K)
    {
      int nk_r = 1 + (len - K) / (K - 1);
      int tail_start = 31 * nk_r + 1;
      for (int i = tail_start; i < len && i - tail_start < 32; ++i)
        dst[i - tail_start] = codes[i];
    }
  }
}

// Device-align telemetry since the last call: rows synthesized from clean
// verdicts, rows that fell back to host alignment, and (verify mode only)
// clean rows whose synthesized Geno diverged from find_genotype_paths.
void gt_device_align_stats(int64_t * out_clean, int64_t * out_fallback, int64_t * out_bad)
{
  *out_clean = g_dal_clean.exchange(0);
  *out_fallback = g_dal_fallback.exchange(0);
  *out_bad = g_dal_bad.exchange(0);
}

void * gt_call_finish(
  void * prep,
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // device seed candidate bitmask ([n_rows, prow] uint32 words, prow =
  // ceil(nk_max*97/32)); null -> host probing of all 97 keys per kmer
  const uint32_t * cand_words, int32_t nk_max,
  // device alignment verdicts ([n_rows, VERD_COLS] int32, ops/device_align
  // layout); null -> host alignment for every rep. verd_verify != 0 runs
  // find_genotype_paths on clean rows too and counts divergences
  // (gt_device_align_stats); the host result wins on divergence.
  const int32_t * verd_rows, int32_t verd_verify,
  // externally-computed rep results (rep-sharded distributed mode,
  // gt_align_fetch layout; ext_row == null -> off). ext_row is [n_rows]
  // (prep row numbering) -> index into the ext geno table or -1.
  const int64_t * ext_row, const int32_t * ext_longest, const int64_t * ext_poff,
  const int64_t * ext_p_start, const int64_t * ext_p_end,
  const int32_t * ext_p_rsi, const int32_t * ext_p_rei, const int32_t * ext_p_mm,
  const int64_t * ext_soff, const int64_t * ext_s_vorder,
  const int64_t * ext_noff, const uint16_t * ext_nums,
  // options
  int32_t n_samples, int32_t hq_reads, int32_t n_threads,
  // optional seed filter handle from gt_seed_filter_build (nullable)
  void * seed_filter,
  // out sizes
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  PrepPool * P = (PrepPool *)prep;
  ExtView ev;
  ExtView * evp = nullptr;
  if (ext_row != nullptr)
  {
    ev = {ext_row, ext_longest, ext_poff, ext_p_start, ext_p_end,
          ext_p_rsi, ext_p_rei, ext_p_mm, ext_soff, ext_s_vorder,
          ext_noff, ext_nums, P->rep_row_fwd.data(), P->rep_row_rc.data()};
    evp = &ev;
  }
  CandView cv;
  CandView * cvp = nullptr;
  if (cand_words != nullptr)
  {
    int64_t prow = ((int64_t)nk_max * 97 + 31) / 32;
    cv = {cand_words, prow, nk_max, P->rep_row_fwd.data(), P->rep_row_rc.data()};
    cvp = &cv;
  }
  VerdView vv;
  VerdView * vvp = nullptr;
  if (verd_rows != nullptr)
  {
    vv = {verd_rows, P->rep_row_fwd.data(), P->rep_row_rc.data(), verd_verify};
    vvp = &vv;
  }
  return finish_from_prep(
    *P,
    ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
    var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
    sp_ref_reach, sp_actual, n_special,
    site_order, site_cnum, site_is_snp, n_sites,
    keys, n_keys, offsets, lab_start, lab_end, lab_var,
    n_samples, hq_reads, n_threads, cvp, (const SeedFilter *)seed_filter, vvp, evp, nullptr,
    out_n_obs, out_n_xvals, out_n_conn, out_n_counts, out_n_touched);
}

// SV-mode finish over a prepared pool (prep computes sv_bad from the raw
// records): the pooled SV loop without any Python record objects. The
// coverage-filter rep pre-pass in run_call_core recomputes dedup (the
// prep's reps don't know about bins), so no device cand bitmask here.
void * gt_call_finish_sv(
  void * prep,
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // options
  int32_t n_samples, int32_t hq_reads, int32_t n_threads,
  void * seed_filter,
  // SV: coverage filter (nullable avg_cov) + depth track to fill
  const double * avg_cov, int32_t * depth, int64_t ref_size, int64_t ref_offset,
  // out sizes
  int64_t * out_n_obs, int64_t * out_n_xvals, int64_t * out_n_conn, int64_t * out_n_counts,
  int64_t * out_n_touched)
{
  PrepPool * P = (PrepPool *)prep;
  SvCtx sv{P->sv_bad.data(), avg_cov, P->pos.empty() ? 0 : P->pos[0],
           depth, ref_size, ref_offset};
  return finish_from_prep(
    *P,
    ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
    var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
    sp_ref_reach, sp_actual, n_special,
    site_order, site_cnum, site_is_snp, n_sites,
    keys, n_keys, offsets, lab_start, lab_end, lab_var,
    n_samples, hq_reads, n_threads, nullptr, (const SeedFilter *)seed_filter, nullptr, nullptr, &sv,
    out_n_obs, out_n_xvals, out_n_conn, out_n_counts, out_n_touched);
}

void gt_prep_free(void * prep)
{
  delete (PrepPool *)prep;
}

// Membership bitset over the sorted index keys (2^bits bits): the device
// kernel filters its 97 probes per kmer against this before the host
// verifies candidates exactly. No false negatives by construction. The
// hash must match ops/seed_probe.py (HASH_C1/HASH_C2).
void gt_build_seed_bitset(const uint64_t * keys, int64_t n_keys, uint32_t * words,
                          int32_t bits)
{
  memset(words, 0, ((size_t)1 << bits) / 8);
  for (int64_t i = 0; i < n_keys; ++i)
  {
    uint32_t lo = (uint32_t)keys[i], hi = (uint32_t)(keys[i] >> 32);
    uint32_t h = (lo * 0x9E3779B1u + hi * 0x85EBCA77u) >> (32 - bits);
    words[h >> 5] |= 1u << (h & 31);
  }
}

void gt_seed_filter_bucket(void * fp, const uint64_t * keys, int64_t n_keys);

// Build the host-side seed filter (exact + Hamming-1-neighborhood bitsets)
// for one index. Sized so the exact set stays ~1-2% loaded and the ham set
// ~6% loaded (96 entries per key); the ham build is the heavy half
// (96*n_keys random ORs) and is threaded.
void * gt_seed_filter_build(const uint64_t * keys, int64_t n_keys, int32_t n_threads)
{
  SeedFilter * f = new SeedFilter();
  int64_t n = std::max<int64_t>(1, n_keys);
  int32_t be = 24;
  while (((int64_t)1 << be) < 64 * n && be < 28)
    ++be;
  int32_t bh = 26;
  while (((int64_t)1 << bh) < 16 * 96 * n && bh < 30)
    ++bh;
  f->bits_e = be;
  f->bits_h = bh;
  gt_seed_filter_bucket(f, keys, n_keys);
  f->exact.assign(((size_t)1 << be) / 32, 0);
  f->ham.assign(((size_t)1 << bh) / 32, 0);
  for (int64_t i = 0; i < n_keys; ++i)
  {
    uint32_t h = SeedFilter::h1(keys[i], be);
    f->exact[h >> 5] |= 1u << (h & 31);
  }
  uint32_t * w = f->ham.data();
  int nt = (n_threads <= 1) ? 1 : std::min<int64_t>(n_threads, (n_keys + 4095) / 4096);
  if (n_keys < 8192)
  {
    // tiny index: the plain scattered build beats the partition setup
    for (int64_t i = 0; i < n_keys; ++i)
    {
      uint64_t base = keys[i];
      for (int kpos = 0; kpos < K; ++kpos)
      {
        uint64_t shift = (uint64_t)kpos * 2;
        uint64_t cur = (base >> shift) & 3ULL;
        uint64_t cleared = base & ~(3ULL << shift);
        for (uint64_t d = 1; d <= 3; ++d)
        {
          uint32_t h = SeedFilter::h2(cleared | ((cur ^ d) << shift), bh);
          w[h >> 5] |= 1u << (h & 31);
        }
      }
    }
    return f;
  }
  // Radix-partitioned two-phase build: scattered atomic ORs over the (up to
  // 64MB) bitset miss cache on nearly every insert. Phase 1 bins the 96
  // neighbor hashes per key by their top bits (sequential writes); phase 2
  // gives each thread exclusive ownership of a run of buckets, so the ORs
  // are plain (no atomics) and confined to an L2-sized bitset slice.
  constexpr int RADIX_BITS = 6;
  constexpr int N_BUCKETS = 1 << RADIX_BITS;
  std::vector<std::vector<std::vector<uint32_t>>> bins(nt);
  auto bin_range = [&](int t, int64_t lo, int64_t hi) {
    auto & mine = bins[t];
    mine.resize(N_BUCKETS);
    size_t expect = (size_t)(hi - lo) * 96 / N_BUCKETS + 16;
    for (auto & b : mine)
      b.reserve(expect + expect / 4);
    int bshift = bh - RADIX_BITS;
    for (int64_t i = lo; i < hi; ++i)
    {
      uint64_t base = keys[i];
      for (int kpos = 0; kpos < K; ++kpos)
      {
        uint64_t shift = (uint64_t)kpos * 2;
        uint64_t cur = (base >> shift) & 3ULL;
        uint64_t cleared = base & ~(3ULL << shift);
        for (uint64_t d = 1; d <= 3; ++d)
        {
          uint32_t h = SeedFilter::h2(cleared | ((cur ^ d) << shift), bh);
          mine[h >> bshift].push_back(h);
        }
      }
    }
  };
  auto or_buckets = [&](int b_lo, int b_hi) {
    for (int b = b_lo; b < b_hi; ++b)
      for (int t = 0; t < nt; ++t)
        for (uint32_t h : bins[t][b])
          w[h >> 5] |= 1u << (h & 31);
  };
  if (nt <= 1)
  {
    bin_range(0, 0, n_keys);
    or_buckets(0, N_BUCKETS);
    return f;
  }
  {
    std::vector<std::thread> threads;
    int64_t per = (n_keys + nt - 1) / nt;
    for (int t = 0; t < nt; ++t)
    {
      int64_t lo = t * per, hi = std::min<int64_t>(n_keys, (t + 1) * per);
      if (lo >= hi)
        bins[t].resize(N_BUCKETS);
      else
        threads.emplace_back(bin_range, t, lo, hi);
    }
    for (auto & th : threads)
      th.join();
  }
  {
    std::vector<std::thread> threads;
    int per = (N_BUCKETS + nt - 1) / nt;
    for (int t = 0; t < nt; ++t)
    {
      int lo = t * per, hi = std::min(N_BUCKETS, (t + 1) * per);
      if (lo < hi)
        threads.emplace_back(or_buckets, lo, hi);
    }
    for (auto & th : threads)
      th.join();
  }
  return f;
}

// Incrementally OR the exact + Hamming-neighborhood bits of `keys` into an
// existing filter. The bitsets are additive-only, so a superset filter is
// still CORRECT for any index (it can only prune less, never wrongly) —
// iteration N+1 of the genotyping loop reuses iteration N's filter and adds
// just the new keys (typically a few percent) instead of rebuilding.
// Caller must guarantee no concurrent readers during the add.
// (Re)build the prefix-bucket accelerator from the key array the filter will
// actually be used against. MUST be re-called after gt_seed_filter_add /
// donor adoption: unlike the bitsets (superset-safe), the bucket table is
// exact — it indexes one specific sorted key array.
void gt_seed_filter_bucket(void * fp, const uint64_t * keys, int64_t n_keys)
{
  SeedFilter * f = (SeedFilter *)fp;
  int64_t n = std::max<int64_t>(1, n_keys);
  int32_t bb = 10;
  while (((int64_t)1 << bb) < n / 4 && bb < 22)
    ++bb;
  size_t nb = (size_t)1 << bb;
  f->bucket.resize(nb + 1);
  int64_t i = 0;
  for (size_t b = 0; b < nb; ++b)
  {
    while (i < n_keys && (keys[i] >> (64 - bb)) < b)
      ++i;
    f->bucket[b] = i;
  }
  f->bucket[nb] = n_keys;
  f->bucket_bits = bb;
}

void gt_seed_filter_add(void * fp, const uint64_t * keys, int64_t n_keys)
{
  SeedFilter * f = (SeedFilter *)fp;
  // the filter now covers a key set the bucket table doesn't describe;
  // drop it until the caller re-attaches via gt_seed_filter_bucket
  f->bucket_bits = 0;
  f->bucket.clear();
  int32_t be = f->bits_e, bh = f->bits_h;
  uint32_t * we = f->exact.data();
  uint32_t * w = f->ham.data();
  for (int64_t i = 0; i < n_keys; ++i)
  {
    uint32_t he = SeedFilter::h1(keys[i], be);
    we[he >> 5] |= 1u << (he & 31);
    uint64_t base = keys[i];
    for (int kpos = 0; kpos < K; ++kpos)
    {
      uint64_t shift = (uint64_t)kpos * 2;
      uint64_t cur = (base >> shift) & 3ULL;
      uint64_t cleared = base & ~(3ULL << shift);
      for (uint64_t d = 1; d <= 3; ++d)
      {
        uint32_t h = SeedFilter::h2(cleared | ((cur ^ d) << shift), bh);
        w[h >> 5] |= 1u << (h & 31);
      }
    }
  }
}

void gt_seed_filter_free(void * f)
{
  delete (SeedFilter *)f;
}

// test hook: bit0 = exact-bitset membership, bit1 = Hamming-neighborhood
// membership for `key`
int32_t gt_seed_filter_test(void * f, uint64_t key)
{
  const SeedFilter * sf = (const SeedFilter *)f;
  return (sf->test_exact(key) ? 1 : 0) | (sf->test_ham(key) ? 2 : 0);
}

// test hook: bucket-accelerated key lookup exactly as find_genotype_paths'
// iget performs it. Returns the index of `key` in `keys` or -1; -2 when no
// bucket table is attached (callers must then fall back to the full search).
int64_t gt_seed_filter_bucket_find(void * f, const uint64_t * keys, int64_t n_keys,
                                   uint64_t key)
{
  const SeedFilter * sf = (const SeedFilter *)f;
  if (sf->bucket_bits <= 0)
    return -2;
  (void)n_keys;
  uint64_t bkt = key >> (64 - sf->bucket_bits);
  const uint64_t * lo = keys + sf->bucket[bkt];
  const uint64_t * hi = keys + sf->bucket[bkt + 1];
  const uint64_t * it = std::lower_bound(lo, hi, key);
  if (it == hi || *it != key)
    return -1;
  return it - keys;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native k-mer index construction (graphtyper_tpu/index/build.py; reference
// semantics src/index/indexer.cpp — rolling partial-kmer entries with
// per-allele forking, 181/4 explosion caps, anti-event phasing constraints,
// special positions for var-internal ends).
// ---------------------------------------------------------------------------

#include <deque>

namespace {

constexpr int MAX_TOTAL_VAR_NUM = 181;
constexpr int MAX_TOTAL_VAR_COUNT = 4;
constexpr uint64_t KMER_MASK = ~0ULL;  // 2*K = 64 bits: full word

struct IdxEntry {
  int64_t start_index = 0;
  uint64_t dna = 0;
  int32_t length = 0;
  int32_t valid = 0;
  std::vector<int64_t> variant_ids;  // sorted unique
  std::vector<int64_t> events;       // sorted unique
  std::vector<int64_t> anti_events;  // sorted unique
  int64_t total_var_num = 1;
  int32_t total_var_count = 0;

  void add_to_dna(uint8_t code)
  {
    dna = (dna << 2) & KMER_MASK;
    length += 1;
    if (valid > 0)
      valid -= 1;
    else if (code < 4)
      dna += code;
    else
      valid = K;
  }
};

static void sorted_insert64(std::vector<int64_t> & v, int64_t x)
{
  auto it = std::lower_bound(v.begin(), v.end(), x);
  if (it == v.end() || *it != x)
    v.insert(it, x);
}

static void sorted_union(std::vector<int64_t> & dst, const int64_t * src, int64_t n)
{
  for (int64_t i = 0; i < n; ++i)
    sorted_insert64(dst, src[i]);
}

static bool sorted_intersects(const std::vector<int64_t> & a, const int64_t * b, int64_t n)
{
  for (int64_t i = 0; i < n; ++i)
    if (std::binary_search(a.begin(), a.end(), b[i]))
      return true;
  return false;
}

struct IdxResult {
  std::vector<uint64_t> kmers;
  std::vector<int64_t> starts, ends, var_ids;
};

struct IdxCtx {
  const GraphView * G;
  // index-encoding arenas (utils/dna.py encode: IUPAC >= 4, no tag rejection)
  const uint8_t * ref_codes_arena;
  const uint8_t * var_codes_arena;
  // per-var-node event CSRs
  const int64_t * ev_off;
  const int64_t * ev_vals;
  const int64_t * anti_off;
  const int64_t * anti_vals;
  IdxResult * R;
};

using Mers = std::deque<std::vector<IdxEntry>>;

static void emit_entry(IdxCtx & C, const IdxEntry & e, int64_t end_index)
{
  if (e.valid > 0)
    return;
  if (e.variant_ids.empty())
  {
    C.R->kmers.push_back(e.dna);
    C.R->starts.push_back(e.start_index);
    C.R->ends.push_back(end_index);
    C.R->var_ids.push_back(INVALID_ID);
  }
  else
  {
    for (int64_t v : e.variant_ids)  // already sorted
    {
      C.R->kmers.push_back(e.dna);
      C.R->starts.push_back(e.start_index);
      C.R->ends.push_back(end_index);
      C.R->var_ids.push_back(v);
    }
  }
}

static void walk_ref(IdxCtx & C, Mers & mers, int64_t order, const uint8_t * codes,
                     int64_t begin, int64_t end)
{
  for (int64_t d = begin; d < end; ++d)
  {
    uint8_t code = codes[d];
    if (code >= 4)
    {
      mers.clear();
      continue;
    }
    for (auto & sub : mers)
      for (auto & e : sub)
        e.add_to_dna(code);
    IdxEntry ne;
    ne.start_index = order + d;
    ne.add_to_dna(code);
    mers.push_front({std::move(ne)});
    if ((int)mers.size() >= K)
    {
      for (auto const & q : mers.back())
        if (q.valid == 0)
          emit_entry(C, q, order + d);
      mers.pop_back();
    }
  }
}

static void index_reference_label(IdxCtx & C, Mers & mers, int64_t order,
                                  const uint8_t * codes, int64_t L)
{
  int64_t walk_until = std::min<int64_t>(K - 1, L);
  walk_ref(C, mers, order, codes, 0, walk_until);
  int64_t d = walk_until;
  if (L - d >= K)
  {
    mers.clear();
    // bulk emission of all fully-internal kmers (positions ascending)
    uint64_t km = 0;
    int bad_run = 0;  // distance since last ambiguous base
    for (int64_t i = 0; i < L; ++i)
    {
      uint8_t c = codes[i];
      km = (km << 2) | (c < 4 ? c : 0);
      bad_run = (c < 4) ? bad_run + 1 : 0;
      if (i >= K - 1 && bad_run >= K)
      {
        int64_t p = i - (K - 1);
        C.R->kmers.push_back(km);
        C.R->starts.push_back(order + p);
        C.R->ends.push_back(order + p + K - 1);
        C.R->var_ids.push_back(INVALID_ID);
      }
    }
    // re-seed partial entries for the trailing K-1 bases (after any N)
    int64_t tail_start = L - (K - 1);
    for (int64_t i = L - 1; i >= tail_start; --i)
      if (codes[i] >= 4)
      {
        tail_start = i + 1;
        break;
      }
    uint64_t val = 0;
    for (int64_t i = L - 1; i >= tail_start; --i)
    {
      val |= (uint64_t)codes[i] << (2 * (L - 1 - i));
      IdxEntry e;
      e.start_index = order + i;
      e.dna = val;
      e.length = (int32_t)(L - i);
      mers.push_back({std::move(e)});
    }
  }
  else
  {
    walk_ref(C, mers, order, codes, d, L);
  }
}

static void insert_variant_label(IdxCtx & C, Mers & mers, int64_t v, bool is_reference,
                                 int64_t var_count, int64_t ref_reach)
{
  const GraphView & G = *C.G;
  const uint8_t * codes = C.var_codes_arena + G.var_dna_start[v];
  int64_t L = G.var_dna_len[v];
  int64_t label_order = G.var_order[v];
  const int64_t * evs = C.ev_vals + C.ev_off[v];
  int64_t n_evs = C.ev_off[v + 1] - C.ev_off[v];
  const int64_t * antis = C.anti_vals + C.anti_off[v];
  int64_t n_antis = C.anti_off[v + 1] - C.anti_off[v];

  for (int64_t d = 0; d < L; ++d)
  {
    uint8_t code = codes[d];
    if (code >= 4)
    {
      mers.clear();
      continue;
    }
    for (auto & sub : mers)
    {
      std::vector<IdxEntry> kept;
      kept.reserve(sub.size());
      for (auto & e : sub)
      {
        if (sorted_intersects(e.anti_events, evs, n_evs))
          continue;  // anti-phased: drop this partial kmer
        e.add_to_dna(code);
        sorted_union(e.events, evs, n_evs);
        sorted_union(e.anti_events, antis, n_antis);
        sorted_insert64(e.variant_ids, v);
        kept.push_back(std::move(e));
      }
      sub = std::move(kept);
    }
    int64_t pos = label_order + d;
    if (pos > ref_reach)
      pos = G.get_special_pos(pos, ref_reach);
    IdxEntry ne;
    ne.start_index = pos;
    ne.total_var_num = (var_count > 0) ? var_count : 1;
    ne.total_var_count = is_reference ? 0 : 1;
    ne.variant_ids.push_back(v);
    ne.add_to_dna(code);
    ne.events.assign(evs, evs + n_evs);
    ne.anti_events.assign(antis, antis + n_antis);
    mers.push_front({std::move(ne)});
    if ((int)mers.size() >= K)
    {
      for (auto const & q : mers.back())
        if (q.valid == 0)
          emit_entry(C, q, pos);
      mers.pop_back();
    }
  }
}

static bool entry_has_too_many_nonrefs(const IdxEntry & e)
{
  return e.total_var_count > 1 &&
         (e.total_var_num > MAX_TOTAL_VAR_NUM || e.total_var_count > MAX_TOTAL_VAR_COUNT);
}

static void append_list(Mers & mers, Mers & other)
{
  while (mers.size() < other.size())
    mers.push_back({});
  for (size_t i = 0; i < other.size(); ++i)
    mers[i].insert(mers[i].end(), std::make_move_iterator(other[i].begin()),
                   std::make_move_iterator(other[i].end()));
}

static void index_variant(IdxCtx & C, Mers & mers, int64_t var_count, int64_t v)
{
  Mers clean_list = mers;  // deep copy
  int64_t ref_label_reach = C.G->var_reach(v);
  insert_variant_label(C, mers, v, true, 1, ref_label_reach);

  for (auto & sub : clean_list)
  {
    std::vector<IdxEntry> kept;
    kept.reserve(sub.size());
    for (auto & e : sub)
    {
      e.total_var_num *= var_count;
      e.total_var_count += 1;
      if (!entry_has_too_many_nonrefs(e))
        kept.push_back(std::move(e));
    }
    sub = std::move(kept);
  }
  int64_t var_num = var_count;

  while (var_count > 2)
  {
    var_count -= 1;
    v += 1;
    Mers new_list = clean_list;  // copy
    insert_variant_label(C, new_list, v, false, var_num, ref_label_reach);
    append_list(mers, new_list);
  }

  v += 1;
  insert_variant_label(C, clean_list, v, false, var_num, ref_label_reach);
  append_list(mers, clean_list);
}

}  // namespace

extern "C" {

void * gt_index_graph(
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_codes_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_codes_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  const int64_t * ev_off, const int64_t * ev_vals,
  const int64_t * anti_off, const int64_t * anti_vals,
  int64_t * out_n_labels)
{
  GraphView G{ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_codes_arena,
              var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_codes_arena,
              sp_ref_reach, sp_actual, n_special, false};
  IdxResult * R = new IdxResult();
  IdxCtx C{&G, ref_codes_arena, var_codes_arena, ev_off, ev_vals, anti_off, anti_vals, R};
  Mers mers;
  for (int64_t r = 0; r + 1 < n_ref; ++r)
  {
    index_reference_label(C, mers, ref_order[r], ref_codes_arena + ref_dna_start[r],
                          ref_dna_len[r]);
    int64_t deg = G.out_deg(r);
    if (deg > 0)
      index_variant(C, mers, deg, G.ref_var_first[r]);
  }
  if (n_ref > 0)
    index_reference_label(C, mers, ref_order[n_ref - 1],
                          ref_codes_arena + ref_dna_start[n_ref - 1], ref_dna_len[n_ref - 1]);
  *out_n_labels = (int64_t)R->kmers.size();
  return R;
}

int32_t gt_index_fetch(void * handle, uint64_t * kmers, int64_t * starts, int64_t * ends,
                       int64_t * var_ids)
{
  IdxResult * R = static_cast<IdxResult *>(handle);
  if (!R)
    return -1;
  memcpy(kmers, R->kmers.data(), R->kmers.size() * sizeof(uint64_t));
  memcpy(starts, R->starts.data(), R->starts.size() * sizeof(int64_t));
  memcpy(ends, R->ends.data(), R->ends.size() * sizeof(int64_t));
  memcpy(var_ids, R->var_ids.data(), R->var_ids.size() * sizeof(int64_t));
  return 0;
}

// Sort the emitted labels by kmer key (stable LSD radix — the exact
// permutation of numpy's stable argsort in index/kmer_index.py build) and
// count the distinct keys. Call after gt_index_graph, then fetch the
// finished CSR layout with gt_index_fetch_sorted.
int64_t gt_index_sort(void * handle)
{
  IdxResult * R = static_cast<IdxResult *>(handle);
  if (!R)
    return -1;
  int64_t n = (int64_t)R->kmers.size();
  std::vector<int64_t> perm(n), tmp(n);
  for (int64_t i = 0; i < n; ++i)
    perm[i] = i;
  // only bytes that actually vary need passes (kmers are 2K-bit packed)
  for (int shift = 0; shift < 64; shift += 8)
  {
    int64_t count[257] = {0};
    bool varies = false;
    uint8_t first = (uint8_t)(n ? (R->kmers[perm[0]] >> shift) : 0);
    for (int64_t i = 0; i < n; ++i)
    {
      uint8_t b = (uint8_t)(R->kmers[perm[i]] >> shift);
      varies |= b != first;
      ++count[b + 1];
    }
    if (!varies)
      continue;
    for (int k = 0; k < 256; ++k)
      count[k + 1] += count[k];
    for (int64_t i = 0; i < n; ++i)
      tmp[count[(uint8_t)(R->kmers[perm[i]] >> shift)]++] = perm[i];
    perm.swap(tmp);
  }
  // apply the permutation
  IdxResult sorted;
  sorted.kmers.resize(n);
  sorted.starts.resize(n);
  sorted.ends.resize(n);
  sorted.var_ids.resize(n);
  int64_t n_keys = 0;
  for (int64_t i = 0; i < n; ++i)
  {
    int64_t p = perm[i];
    sorted.kmers[i] = R->kmers[p];
    sorted.starts[i] = R->starts[p];
    sorted.ends[i] = R->ends[p];
    sorted.var_ids[i] = R->var_ids[p];
    if (i == 0 || sorted.kmers[i] != sorted.kmers[i - 1])
      ++n_keys;
  }
  *R = std::move(sorted);
  return n_keys;
}

// CSR fetch after gt_index_sort: unique keys + offsets, labels permuted.
int32_t gt_index_fetch_sorted(void * handle, uint64_t * keys, int64_t * offsets,
                              int64_t * starts, int64_t * ends, int64_t * var_ids)
{
  IdxResult * R = static_cast<IdxResult *>(handle);
  if (!R)
    return -1;
  int64_t n = (int64_t)R->kmers.size();
  memcpy(starts, R->starts.data(), n * sizeof(int64_t));
  memcpy(ends, R->ends.data(), n * sizeof(int64_t));
  memcpy(var_ids, R->var_ids.data(), n * sizeof(int64_t));
  int64_t u = 0;
  for (int64_t i = 0; i < n; ++i)
  {
    if (i == 0 || R->kmers[i] != R->kmers[i - 1])
    {
      keys[u] = R->kmers[i];
      offsets[u] = i;
      ++u;
    }
  }
  offsets[u] = n;
  return 0;
}

void gt_index_free(void * handle)
{
  delete static_cast<IdxResult *>(handle);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming pooled caller: bounded-memory merge of N BAM files.
//
// The in-memory path decompresses every pool file and materializes the whole
// (pos, seq)-sorted record array before calling; at population scale that is
// O(total reads) RSS. This path reproduces the reference's design
// (src/utilities/hts_parallel_reader.cpp:85-136 heap merge over per-file
// position-sorted buffers, hts_reader.cpp:166-235 same-position seq sort):
// each file streams through a BGZF block reader, records merge through a
// heap in (pos, seq, file) order, and fixed-size batches flow through the
// same stage-1 alignment + stage-2 scoring code as the in-memory caller
// (stage2_one_record), with pair-pending maps, eps saturation state and
// phasing connections persisting across batches. Observation rows drain to
// the caller per batch (gt_stream_step/gt_stream_fetch_obs), so resident
// memory is O(batch + open files + site state), independent of cohort
// size. Byte-identical output: per-sample record order is unchanged and
// every scoring update is replayed in the same order as the in-memory
// caller.
// ---------------------------------------------------------------------------

#include <cstdio>
#include <queue>

namespace {

struct BgzfIn {
  FILE * f = nullptr;
  std::vector<uint8_t> cbuf;
  size_t cpos = 0;
  std::vector<uint8_t> dbuf;
  size_t dpos = 0;
  void * dec = nullptr;  // libdeflate_decompressor (via gt_native helpers)
  bool file_eof = false;

  bool open_file(const char * path);
  void close_file();
  bool fill_compressed(size_t need)
  {
    // 256KB read chunks (>= 4 full BGZF blocks): per-open-file resident
    // memory is the streaming caller's dominant fixed cost at high file
    // counts, so keep the per-file buffers small
    constexpr size_t CHUNK = 256 << 10;
    while (cbuf.size() - cpos < need && !file_eof)
    {
      if (cpos > 0)
      {
        cbuf.erase(cbuf.begin(), cbuf.begin() + cpos);
        cpos = 0;
      }
      size_t old = cbuf.size();
      cbuf.resize(old + CHUNK);
      size_t got = fread(cbuf.data() + old, 1, CHUNK, f);
      cbuf.resize(old + got);
      if (got == 0)
        file_eof = true;
    }
    return cbuf.size() - cpos >= need;
  }
  bool inflate_block();
  bool ensure(size_t n)
  {
    while (dbuf.size() - dpos < n)
      if (!inflate_block())
        return false;
    return true;
  }
};

struct SRec {
  int64_t pos = 0;
  std::string seq;  // ASCII (BAM nibble decode: uppercase canonical)
  std::vector<uint8_t> body;  // record bytes after block_size
};

struct StreamFile {
  BgzfIn z;
  int32_t target = -2;
  int32_t sample = 0;
  // region gate (SV pools): keep only reads overlapping
  // [filter_begin, filter_end) — the reference's index-iterator record set
  // (same span rule as parse_one_file above)
  int64_t filter_begin = -1, filter_end = -1;
  std::deque<SRec> run;  // same-pos run, seq-sorted
  bool have_peek = false;
  SRec peek;
  bool exhausted = false;
  // shared SRec freelist (owned by StreamCall; fill is single-threaded, so
  // no locking): recycles body/seq heap buffers instead of one alloc+free
  // pair per record — the extract loop measured larger than decode+parse
  // on config 4 and allocation churn was a top term
  std::vector<SRec> * pool = nullptr;
  std::vector<SRec> tmp_run;  // scratch for the same-pos sort, capacity kept

  SRec take()
  {
    if (pool != nullptr && !pool->empty())
    {
      SRec r = std::move(pool->back());
      pool->pop_back();
      return r;
    }
    return SRec();
  }

  bool parse_next(SRec & out)
  {
    static const char NIB[17] = "=ACMGRSVTWYHKDBN";
    for (;;)
    {
      if (!z.ensure(4))
        return false;
      int32_t bs;
      memcpy(&bs, z.dbuf.data() + z.dpos, 4);
      if (bs <= 0 || !z.ensure(4 + (size_t)bs))
        return false;
      const uint8_t * p = z.dbuf.data() + z.dpos + 4;
      int32_t ref_id, pos;
      memcpy(&ref_id, p, 4);
      memcpy(&pos, p + 4, 4);
      if (ref_id == target && filter_begin >= 0)
      {
        uint8_t l_rn = p[8];
        uint16_t nc;
        memcpy(&nc, p + 12, 2);
        int64_t span = 0;
        const uint8_t * cg = p + 32 + l_rn;
        for (uint16_t ci = 0; ci < nc; ++ci)
        {
          uint32_t c;
          memcpy(&c, cg + 4 * ci, 4);
          uint32_t op = c & 0xF;
          if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)  // M D N = X
            span += c >> 4;
        }
        if (span == 0)
          span = 1;
        if (!(pos < filter_end && pos + span > filter_begin))
        {
          z.dpos += 4 + bs;
          continue;
        }
      }
      if (ref_id == target)
      {
        out.pos = pos;
        out.body.assign(p, p + bs);
        uint8_t l_read_name = p[8];
        uint16_t n_cigar;
        memcpy(&n_cigar, p + 12, 2);
        int32_t l_seq;
        memcpy(&l_seq, p + 16, 4);
        const uint8_t * s = p + 32 + l_read_name + 4 * n_cigar;
        out.seq.resize(l_seq);
        char * dst = &out.seq[0];
        int i = 0;
        for (; i + 2 <= l_seq; i += 2)
        {
          uint8_t b = s[i >> 1];
          dst[i] = NIB[b >> 4];
          dst[i + 1] = NIB[b & 0xF];
        }
        if (i < l_seq)
          dst[i] = NIB[s[i >> 1] >> 4];
        z.dpos += 4 + bs;
        return true;
      }
      z.dpos += 4 + bs;
    }
  }

  bool next(SRec & out)
  {
    if (run.empty())
    {
      SRec first;
      if (have_peek)
      {
        first = std::move(peek);
        have_peek = false;
      }
      else
      {
        first = take();
        if (!parse_next(first))
        {
          if (pool != nullptr)
            pool->push_back(std::move(first));
          exhausted = true;
          return false;
        }
      }
      int64_t p0 = first.pos;
      tmp_run.clear();
      tmp_run.push_back(std::move(first));
      for (;;)
      {
        SRec nx = take();
        if (!parse_next(nx))
        {
          if (pool != nullptr)
            pool->push_back(std::move(nx));
          break;
        }
        if (nx.pos != p0)
        {
          peek = std::move(nx);
          have_peek = true;
          break;
        }
        tmp_run.push_back(std::move(nx));
      }
      std::stable_sort(tmp_run.begin(), tmp_run.end(),
                       [](const SRec & a, const SRec & b) { return a.seq < b.seq; });
      for (auto & t : tmp_run)
        run.push_back(std::move(t));
      tmp_run.clear();
    }
    out = std::move(run.front());
    run.pop_front();
    return true;
  }
};

// heap of (pos, seq, file) over each file's current record
struct HeapEnt {
  int64_t pos;
  const std::string * seq;
  int32_t fi;
};
struct HeapCmp {
  bool operator()(const HeapEnt & a, const HeapEnt & b) const
  {
    if (a.pos != b.pos)
      return a.pos > b.pos;
    int c = a.seq->compare(*b.seq);
    if (c != 0)
      return c > 0;
    return a.fi > b.fi;
  }
};

// One filled batch of parsed records, staged ahead of the compute stages.
// The fill phase (BGZF inflate + BAM parse + heap merge) measured ~55% of
// the stream caller's wall on cohort workloads and is inherently serial per
// pool, so batch N+1 fills on a background thread while batch N's align +
// replay stages (and the Python-side scoring between steps) run.
struct StagedBatch {
  std::vector<uint8_t> read_codes, names, quals, same_ref, sv_bad_v;
  std::vector<int64_t> read_off{0}, name_off{0}, qual_off{0}, pos_v;
  std::vector<int32_t> flags_v, mapq_v, tlen_v, sdiff_v, clip_v, rg_v;

  void reset()
  {
    read_codes.clear(); names.clear(); quals.clear(); same_ref.clear(); sv_bad_v.clear();
    read_off.assign(1, 0); name_off.assign(1, 0); qual_off.assign(1, 0); pos_v.clear();
    flags_v.clear(); mapq_v.clear(); tlen_v.clear(); sdiff_v.clear(); clip_v.clear();
    rg_v.clear();
  }
};

// Stream handle: open files + persistent caller state across batches.
struct StreamCall {
  std::vector<StreamFile> files;
  std::priority_queue<HeapEnt, std::vector<HeapEnt>, HeapCmp> heap;
  std::vector<SRec> current;  // per file: record backing the heap entry

  // graph/index/site views (owned copies of the flat arrays' pointers are
  // NOT safe across Python calls — the caller passes them per step)
  int32_t n_samples = 0, sam_flag_filter = 0, force_both = 0, hq_reads = 0;
  int32_t n_threads = 1;
  int64_t batch_records = 1 << 18;
  int64_t n_sites = 0;

  // persistent stage-2 state
  std::vector<CallResult> parts;
  std::vector<std::pair<int32_t, int32_t>> ranges;
  std::vector<std::vector<std::unordered_map<std::string, Pending>>> maps;  // per worker
  CallResult * R = nullptr;  // final accumulation (counts, eps, conn)

  // dedup carry across batches
  bool have_prev = false;
  int64_t prev_pos = -1;
  std::vector<uint8_t> prev_codes;
  std::pair<Geno, Geno> carried_aligned;

  // per-batch drained observation rows
  CallResult batch_obs;

  // SV mode (VERDICT r3 #6): is_good_sv_read gate + 50bp/3x coverage bins +
  // ReferenceDepth, all persistent across batches; leftover mates resolve at
  // finish from the persistent Pending maps (hts_parallel_reader.cpp:599-772
  // analog)
  int32_t is_sv = 0;
  std::vector<double> avg_cov_store;      // empty = no coverage filter
  int32_t * depth = nullptr;              // borrowed from Python (kept alive)
  int64_t depth_ref_size = 0, depth_ref_offset = 0;
  int64_t first_pos = -1;                 // pos of the pool's first record
  std::vector<std::unordered_map<int64_t, int32_t>> bins;  // per sample
  std::vector<int64_t> ins_counters;      // per worker: Pending insert order

  bool eof = false;

  // staged-batch spill (cross-iteration fill reuse): call iterations 2 and
  // 3 of the genotype loop stream the IDENTICAL record sequence from the
  // same BAMs (the staged batch is per-record pure, emitted before any
  // stateful dedup/gating) — iteration 2 spills each frame to disk and
  // iteration 3 replays them, skipping decompress+parse+extract entirely.
  // A trailer with the total record count is written only when the stream
  // fully drains; replay validates it at attach and at drain.
  FILE * spill_w = nullptr;
  FILE * spill_r = nullptr;
  std::string spill_path;
  int64_t spill_written = 0;   // records framed so far (write mode)
  int64_t spill_expected = -1; // trailer count (read mode)
  int64_t spill_seen = 0;      // records replayed so far (read mode)
  bool spill_drained = false;
  int spill_error = 0;

  // device-align pipeline: batches staged (dedup done, rep rows computed)
  // awaiting their device verdicts; gt_stream_stage pushes, gt_stream_step
  // pops in order. At most a couple in flight (Python stages one ahead).
  struct PendingBatch {
    StagedBatch B;
    std::vector<int64_t> reps, rep_of;
    std::vector<uint8_t> skip;
    std::vector<int64_t> rep_row_fwd, rep_row_rc, row_rep;
    std::vector<uint8_t> row_is_rc;
  };
  std::deque<PendingBatch> pending_q;

  // prefill pipeline: the next batch staged by a background thread. Only
  // the fill path touches files/heap/current, and exactly one fill runs at
  // a time (synchronous first fill, then one prefill thread joined at the
  // top of each step), so no locking is needed.
  StagedBatch staged;
  StagedBatch spare;  // last consumed batch's buffers, recycled into staged
  bool staged_valid = false;
  std::thread prefill;
  bool prefill_active = false;
  std::vector<SRec> srec_pool;  // shared record freelist (fill-thread only)

  // GT_NATIVE_PROFILE phase totals (printed at finish). fill = CPU time of
  // the fill work itself (wherever it ran); wait = time the step blocked
  // joining the prefill thread (the EXPOSED fill cost after overlap).
  int64_t prof_fill_ns = 0, prof_stage1_ns = 0, prof_stage2_ns = 0;
  int64_t prof_wait_ns = 0;
  int64_t prof_align_ns = 0, prof_replay_ns = 0;  // sub-phases of stage1
  int64_t prof_next_ns = 0;  // within fill: decode+parse+sort (StreamFile::next)
};

bool BgzfIn::open_file(const char * path)
{
  f = fopen(path, "rb");
  return f != nullptr;
}

void BgzfIn::close_file()
{
  if (f)
    fclose(f);
  f = nullptr;
}

}  // namespace

// gzip member inflate, provided by gt_native.cpp
extern "C" int64_t gt_bgzf_decompress(uint8_t const * in, int64_t in_size, uint8_t * out,
                                      int64_t out_capacity);

namespace {

bool BgzfIn::inflate_block()
{
  if (!fill_compressed(18))
    return false;
  const uint8_t * h = cbuf.data() + cpos;
  if (h[0] != 0x1f || h[1] != 0x8b)
    return false;
  uint16_t xlen;
  memcpy(&xlen, h + 10, 2);
  if (!fill_compressed(12 + (size_t)xlen))
    return false;
  h = cbuf.data() + cpos;
  int64_t bsize = -1;
  const uint8_t * x = h + 12;
  int rem = xlen;
  while (rem >= 4)
  {
    uint16_t slen;
    memcpy(&slen, x + 2, 2);
    if (x[0] == 'B' && x[1] == 'C' && slen == 2)
    {
      uint16_t bs;
      memcpy(&bs, x + 4, 2);
      bsize = (int64_t)bs + 1;
      break;
    }
    x += 4 + slen;
    rem -= 4 + slen;
  }
  if (bsize < 12 || !fill_compressed((size_t)bsize))
    return false;
  h = cbuf.data() + cpos;
  uint32_t isize;
  memcpy(&isize, h + bsize - 4, 4);
  if (dpos > 0)
  {
    dbuf.erase(dbuf.begin(), dbuf.begin() + dpos);
    dpos = 0;
  }
  size_t old = dbuf.size();
  dbuf.resize(old + isize);
  if (isize > 0)
  {
    int64_t got = gt_bgzf_decompress(h, bsize, dbuf.data() + old, isize);
    if (got != (int64_t)isize)
      return false;
  }
  cpos += (size_t)bsize;
  return isize > 0 || bsize > 28;  // empty EOF block ends the stream
}

// ASCII -> code table (utils/dna.py _CODE), as in parse_bam_pool
const uint8_t * stream_code_table()
{
  static const std::array<uint8_t, 256> table = [] {
    std::array<uint8_t, 256> t{};
    t.fill(4);
    const char * bases = "ACGT";
    for (int i = 0; i < 4; ++i)
    {
      t[(uint8_t)bases[i]] = i;
      t[(uint8_t)(bases[i] + 32)] = i;
    }
    t[(uint8_t)'U'] = t[(uint8_t)'u'] = 3;
    const char * iupac = "NRYSWKMBDHV";
    for (int i = 0; iupac[i]; ++i)
    {
      t[(uint8_t)iupac[i]] = 4 + i;
      t[(uint8_t)(iupac[i] + 32)] = 4 + i;
    }
    return t;
  }();
  return table.data();
}

constexpr uint64_t SPILL_MAGIC1 = 0x47545350494c4c31ULL;  // "GTSPILL1"
constexpr uint64_t SPILL_MAGIC2 = 0x47545350494c4c32ULL;  // trailer

static bool spill_write_frame(FILE * f, const StagedBatch & B)
{
  int64_t n = (int64_t)B.pos_v.size();
  int64_t lens[5] = {n, (int64_t)B.read_codes.size(), (int64_t)B.names.size(),
                     (int64_t)B.quals.size(), (int64_t)B.sv_bad_v.size()};
  auto W = [&](const void * p, size_t bytes) {
    return bytes == 0 || fwrite(p, 1, bytes, f) == bytes;
  };
  return W(lens, sizeof lens) &&
         W(B.read_off.data(), (size_t)(n + 1) * 8) &&
         W(B.name_off.data(), (size_t)(n + 1) * 8) &&
         W(B.qual_off.data(), (size_t)(n + 1) * 8) &&
         W(B.pos_v.data(), (size_t)n * 8) &&
         W(B.flags_v.data(), (size_t)n * 4) && W(B.mapq_v.data(), (size_t)n * 4) &&
         W(B.tlen_v.data(), (size_t)n * 4) && W(B.sdiff_v.data(), (size_t)n * 4) &&
         W(B.clip_v.data(), (size_t)n * 4) && W(B.rg_v.data(), (size_t)n * 4) &&
         W(B.same_ref.data(), (size_t)n) &&
         W(B.sv_bad_v.data(), B.sv_bad_v.size()) &&
         W(B.read_codes.data(), B.read_codes.size()) &&
         W(B.names.data(), B.names.size()) &&
         W(B.quals.data(), B.quals.size());
}

// returns 1 = frame read, 0 = clean EOF (trailer reached), -1 = corrupt
static int spill_read_frame(FILE * f, StagedBatch & B)
{
  B.reset();
  uint64_t first;
  if (fread(&first, 1, 8, f) != 8)
    return -1;  // a complete spill always ends with a trailer, never EOF
  if (first == SPILL_MAGIC2)
    return 0;
  int64_t lens[5];
  lens[0] = (int64_t)first;
  if (fread(lens + 1, 1, 32, f) != 32)
    return -1;
  int64_t n = lens[0];
  if (n < 0 || lens[1] < 0 || lens[2] < 0 || lens[3] < 0 || lens[4] < 0)
    return -1;
  auto R = [&](auto & v, int64_t count) {
    v.resize(count);
    return count == 0 ||
           fread(v.data(), 1, (size_t)count * sizeof(v[0]), f) ==
             (size_t)count * sizeof(v[0]);
  };
  if (!R(B.read_off, n + 1) || !R(B.name_off, n + 1) || !R(B.qual_off, n + 1) ||
      !R(B.pos_v, n) || !R(B.flags_v, n) || !R(B.mapq_v, n) || !R(B.tlen_v, n) ||
      !R(B.sdiff_v, n) || !R(B.clip_v, n) || !R(B.rg_v, n) || !R(B.same_ref, n) ||
      !R(B.sv_bad_v, lens[4]) || !R(B.read_codes, lens[1]) || !R(B.names, lens[2]) ||
      !R(B.quals, lens[3]))
    return -1;
  return 1;
}

// Fill one batch of records from the heap into B. Touches ONLY
// files/heap/current/first_pos (fills are serialized: either synchronous or
// on the single prefill thread, never both at once). Everything emitted is
// per-record pure — dedup/gating state stays on the step thread.
void fill_one_batch(StreamCall * S, StagedBatch & B)
{
  if (S->spill_r != nullptr)
  {
    int r = spill_read_frame(S->spill_r, B);
    if (r <= 0)
    {
      if (r < 0 || S->spill_seen != S->spill_expected)
        S->spill_error = 1;
      S->spill_drained = true;
      return;
    }
    S->spill_seen += (int64_t)B.pos_v.size();
    if (S->spill_seen > S->spill_expected)
      S->spill_error = 1;
    return;
  }
  const uint8_t * CODE = stream_code_table();
  B.reset();
  int64_t cap = S->batch_records;
  bool prof = prof_enabled();
  auto & read_codes = B.read_codes;
  auto & names = B.names;
  auto & quals = B.quals;
  auto & same_ref = B.same_ref;
  auto & sv_bad_v = B.sv_bad_v;
  auto & read_off = B.read_off;
  auto & name_off = B.name_off;
  auto & qual_off = B.qual_off;
  auto & pos_v = B.pos_v;
  auto & flags_v = B.flags_v;
  auto & mapq_v = B.mapq_v;
  auto & tlen_v = B.tlen_v;
  auto & sdiff_v = B.sdiff_v;
  auto & clip_v = B.clip_v;
  auto & rg_v = B.rg_v;

  while ((int64_t)pos_v.size() < cap && !S->heap.empty())
  {
    HeapEnt e = S->heap.top();
    S->heap.pop();
    SRec rec = std::move(S->current[e.fi]);
    // advance that file
    int64_t nx0 = prof ? prof_now() : 0;
    if (S->files[e.fi].next(S->current[e.fi]))
      S->heap.push({S->current[e.fi].pos, &S->current[e.fi].seq, e.fi});
    if (prof)
      S->prof_next_ns += prof_now() - nx0;

    const uint8_t * p = rec.body.data();
    int32_t bs = (int32_t)rec.body.size();
    uint8_t l_read_name = p[8];
    uint8_t mapq8 = p[9];
    uint16_t n_cigar, flag16;
    memcpy(&n_cigar, p + 12, 2);
    memcpy(&flag16, p + 14, 2);
    int32_t l_seq, next_ref, next_pos, tl;
    memcpy(&l_seq, p + 16, 4);
    memcpy(&next_ref, p + 20, 4);
    memcpy(&next_pos, p + 24, 4);
    memcpy(&tl, p + 28, 4);
    int32_t ref_id;
    memcpy(&ref_id, p, 4);
    if (S->first_pos < 0)
      S->first_pos = rec.pos;
    if (S->is_sv)
    {
      // is_good_sv_read (caller.py:79-93, hts_parallel_reader.cpp:528-568)
      bool bad = false;
      const uint8_t * cg = p + 32 + l_read_name;
      if (flag16 & 0x4)
        bad = true;
      else
      {
        bool far = ref_id != next_ref ||
                   (rec.pos > next_pos ? rec.pos - next_pos : next_pos - rec.pos) > 200000;
        if (mapq8 <= 15 && far)
          bad = true;
        else if (n_cigar >= 2)
        {
          uint32_t c0, cl;
          memcpy(&c0, cg, 4);
          memcpy(&cl, cg + 4 * (n_cigar - 1), 4);
          bool front_s = (c0 & 0xF) == 4, back_s = (cl & 0xF) == 4;
          bool one_clipped = (front_s && (c0 >> 4) >= 12) || (back_s && (cl >> 4) >= 12);
          if ((front_s && back_s) || (mapq8 <= 15 && one_clipped))
            bad = true;
        }
      }
      sv_bad_v.push_back(bad ? 1 : 0);
    }

    pos_v.push_back(rec.pos);
    flags_v.push_back(flag16);
    mapq_v.push_back(mapq8);
    tlen_v.push_back(tl);
    same_ref.push_back(ref_id == next_ref ? 1 : 0);
    rg_v.push_back(S->files[e.fi].sample);

    const uint8_t * q = p + 32;
    names.insert(names.end(), q, q + l_read_name - 1);
    name_off.push_back((int64_t)names.size());
    q += l_read_name;
    int32_t clip = 0;
    if (n_cigar > 0)
    {
      uint32_t c0, cl;
      memcpy(&c0, q, 4);
      memcpy(&cl, q + 4 * (n_cigar - 1), 4);
      if ((c0 & 0xF) == 4)
        clip = (int32_t)(c0 >> 4);
      else if ((cl & 0xF) == 4)
        clip = (int32_t)(cl >> 4);
    }
    clip_v.push_back(clip);
    q += 4 * n_cigar;
    {
      size_t old_sz = read_codes.size(), slen = rec.seq.size();
      read_codes.resize(old_sz + slen);
      uint8_t * dst = read_codes.data() + old_sz;
      const char * src = rec.seq.data();
      for (size_t i = 0; i < slen; ++i)
        dst[i] = CODE[(uint8_t)src[i]];
    }
    read_off.push_back((int64_t)read_codes.size());
    q += (l_seq + 1) / 2;
    quals.insert(quals.end(), q, q + l_seq);
    qual_off.push_back((int64_t)quals.size());
    q += l_seq;

    // AS/XS -> score_diff (same walk as parse_bam_pool)
    const uint8_t * end = p + bs;
    int64_t as_ = -1, xs = -1;
    while (q + 3 <= end)
    {
      char t0 = q[0], t1 = q[1], typ = q[2];
      q += 3;
      int64_t val = 0;
      int adv = 0;
      switch (typ)
      {
      case 'A': val = q[0]; adv = 1; break;
      case 'c': val = (int8_t)q[0]; adv = 1; break;
      case 'C': val = q[0]; adv = 1; break;
      case 's': { int16_t v; memcpy(&v, q, 2); val = v; adv = 2; break; }
      case 'S': { uint16_t v; memcpy(&v, q, 2); val = v; adv = 2; break; }
      case 'i': { int32_t v; memcpy(&v, q, 4); val = v; adv = 4; break; }
      case 'I': { uint32_t v; memcpy(&v, q, 4); val = v; adv = 4; break; }
      case 'f': adv = 4; break;
      case 'Z': case 'H': {
        const uint8_t * z = q;
        while (z < end && *z)
          ++z;
        adv = (int)(z - q) + 1;
        break;
      }
      case 'B': {
        char sub = (char)q[0];
        uint32_t cnt;
        memcpy(&cnt, q + 1, 4);
        int es = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        adv = 5 + es * (int)cnt;
        break;
      }
      default: adv = (int)(end - q); break;
      }
      if (t0 == 'A' && t1 == 'S')
        as_ = val;
      if (t0 == 'X' && t1 == 'S')
        xs = val;
      q += adv;
    }
    int64_t sd = 0;
    if (!(as_ == -1 || as_ < xs))
    {
      if (xs == -1)
        xs = 0;
      sd = std::min<int64_t>(as_ - xs, 255);
    }
    sdiff_v.push_back((int32_t)sd);

    // recycle the record's heap buffers (bounded freelist)
    if (S->srec_pool.size() < 1024)
    {
      rec.body.clear();
      rec.seq.clear();
      S->srec_pool.push_back(std::move(rec));
    }
  }

  if (S->spill_w != nullptr)
  {
    if (!spill_write_frame(S->spill_w, B))
    {
      // disk full / IO error: stop spilling, drop the partial file at close
      fclose(S->spill_w);
      S->spill_w = nullptr;
      ::remove(S->spill_path.c_str());
      S->spill_written = -1;
    }
    else
      S->spill_written += (int64_t)B.pos_v.size();
  }
}

}  // namespace

extern "C" {

// Open the stream: parse headers, resolve the target contig per file, prime
// the heap. Returns a handle or null (caller falls back to the in-memory
// path on any unsupported condition).
void * gt_stream_open(const char * const * paths, const int32_t * sample_of, int64_t n_files,
                      const char * target_chr,
                      int32_t n_samples, int32_t sam_flag_filter, int32_t force_both,
                      int32_t hq_reads, int32_t n_threads, int64_t batch_records,
                      int64_t n_sites,
                      // SV mode (all zero/null for SNP pools)
                      int64_t filter_begin, int64_t filter_end, int32_t is_sv,
                      const double * avg_cov, int32_t * depth, int64_t depth_ref_size,
                      int64_t depth_ref_offset)
{
  StreamCall * S = new StreamCall();
  S->files.resize(n_files);
  S->current.resize(n_files);
  S->n_samples = n_samples;
  S->sam_flag_filter = sam_flag_filter;
  S->force_both = force_both;
  S->hq_reads = hq_reads;
  S->n_threads = n_threads;
  S->batch_records = batch_records > 0 ? batch_records : (1 << 18);
  S->n_sites = n_sites;
  S->is_sv = is_sv;
  if (avg_cov != nullptr)
    S->avg_cov_store.assign(avg_cov, avg_cov + n_samples);
  S->depth = depth;
  S->depth_ref_size = depth_ref_size;
  S->depth_ref_offset = depth_ref_offset;
  if (is_sv && !S->avg_cov_store.empty())
    S->bins.resize(n_samples);

  for (int64_t fi = 0; fi < n_files; ++fi)
  {
    StreamFile & F = S->files[fi];
    F.sample = sample_of[fi];
    F.filter_begin = filter_begin;
    F.filter_end = filter_end;
    F.pool = &S->srec_pool;
    if (!F.z.open_file(paths[fi]))
    {
      delete S;
      return nullptr;
    }
    // header: magic, l_text, text, n_ref, names
    if (!F.z.ensure(12) || memcmp(F.z.dbuf.data(), "BAM\1", 4) != 0)
    {
      delete S;
      return nullptr;
    }
    int32_t l_text;
    memcpy(&l_text, F.z.dbuf.data() + 4, 4);
    if (!F.z.ensure(12 + (size_t)l_text))
    {
      delete S;
      return nullptr;
    }
    size_t off = 8 + (size_t)l_text;
    int32_t nref;
    memcpy(&nref, F.z.dbuf.data() + off, 4);
    off += 4;
    F.target = -2;
    for (int32_t i = 0; i < nref; ++i)
    {
      if (!F.z.ensure(off + 8 - F.z.dpos))
      {
        delete S;
        return nullptr;
      }
      int32_t l_name;
      memcpy(&l_name, F.z.dbuf.data() + off, 4);
      if (!F.z.ensure(off + 8 + (size_t)l_name - F.z.dpos))
      {
        delete S;
        return nullptr;
      }
      const char * nm = (const char *)F.z.dbuf.data() + off + 4;
      if ((int32_t)strlen(target_chr) == l_name - 1 && memcmp(nm, target_chr, l_name - 1) == 0)
        F.target = i;
      off += 8 + (size_t)l_name;
    }
    F.z.dpos = off;
    if (F.next(S->current[fi]))
      S->heap.push({S->current[fi].pos, &S->current[fi].seq, (int32_t)fi});
  }

  // persistent workers
  int nt = (n_threads <= 1) ? 1 : std::min<int32_t>(n_threads, n_samples);
  int per = (n_samples + nt - 1) / nt;
  S->parts.resize(nt);
  for (int t = 0; t < nt; ++t)
  {
    int32_t slo = t * per, shi = std::min<int32_t>(n_samples, (t + 1) * per);
    if (slo >= shi)
      break;
    S->parts[S->ranges.size()].eps_sum.assign(n_sites * n_samples, 0);
    S->ranges.push_back({slo, shi});
    S->maps.emplace_back(shi - slo);
  }
  S->ins_counters.assign(S->ranges.size(), 0);
  S->R = new CallResult();
  S->R->eps_sum.assign(n_sites * n_samples, 0);
  return S;
}

// Process ONE batch through stage 1 + stage 2 with the given graph/index.
// Returns 1 with the batch's observation-row counts (drain them with
// gt_stream_fetch_obs before the next step), or 0 at end of stream.
// Stage one batch: take the prefilled staged buffers, kick the next prefill,
// and run the stateful dedup (cross-batch carry, SV gates/bins). Returns 1
// on success (P filled), 0 when the stream is drained, -1 on spill error.
static int stream_stage_one(StreamCall * S, StreamCall::PendingBatch & P)
{
  int64_t prof_t0 = prof_enabled() ? prof_now() : 0;
  if (S->prefill_active)
  {
    S->prefill.join();  // exposed fill cost = this wait
    S->prefill_active = false;
  }
  if (!S->staged_valid)
  {
    if (S->spill_r != nullptr ? S->spill_drained : S->heap.empty())
      return S->spill_error ? -1 : 0;
    int64_t f0 = prof_enabled() ? prof_now() : 0;
    fill_one_batch(S, S->staged);  // first batch (or post-drain): synchronous
    S->staged_valid = true;
    if (prof_enabled())
      S->prof_fill_ns += prof_now() - f0;
  }
  if (S->spill_error)
    return -1;
  P.B = std::move(S->staged);
  // rotate the previously consumed batch's buffers back in: per-batch large
  // allocations (tens of MB) and their first-touch page faults measured as
  // a top extract-phase term on config 4
  S->staged = std::move(S->spare);
  S->spare = StagedBatch();
  S->staged_valid = false;
  if (prof_enabled())
    S->prof_wait_ns += prof_now() - prof_t0;

  // kick off the next batch's fill; it runs concurrently with this batch's
  // align/replay stages AND with the Python-side scoring/device work between
  // steps (fill owns files/heap/first_pos exclusively until joined).
  // Interleaved A/B on BASELINE config 4 (4-core host fully saturated by 4
  // region workers): neutral within noise (off 41.4/39.0s, on 38.9/39.1s);
  // on a many-core host running fewer workers it hides the ~55% fill phase
  // behind align/replay + the Python scoring between steps.
  // GT_STREAM_PREFILL=0 disables.
  static const bool prefill_on = [] {
    const char * e = getenv("GT_STREAM_PREFILL");
    return e == nullptr || e[0] != '0';
  }();
  if (prefill_on && (S->spill_r != nullptr ? !S->spill_drained : !S->heap.empty()))
  {
    S->prefill_active = true;
    bool prof = prof_enabled();
    S->prefill = std::thread([S, prof] {
      int64_t f0 = prof ? prof_now() : 0;
      fill_one_batch(S, S->staged);
      S->staged_valid = true;
      if (prof)
        S->prof_fill_ns += prof_now() - f0;
    });
  }

  StagedBatch & B = P.B;
  int64_t n = (int64_t)B.pos_v.size();

  // ---- dedup within batch, with cross-batch carry ------------------------
  // rep_of[i] >= 0 indexes this batch's reps; -1 = carried rep from the
  // previous batch; -2 = filtered record. SV mode replays run_call_core's
  // gate order exactly: sv_bad reads are transparent to the dedup carry,
  // duplicates always update their coverage bin, new keys are bin-gated.
  std::vector<int64_t> & reps = P.reps;
  std::vector<int64_t> & rep_of = P.rep_of;
  reps.clear();
  rep_of.assign(n, -2);
  P.skip.assign(S->is_sv ? n : 0, 0);
  bool cov_filter = S->is_sv && !S->avg_cov_store.empty();
  auto bin_update = [&](int32_t s, int64_t p) -> bool {
    double ac = S->avg_cov_store[s];
    if (ac <= 0.0)
      return true;
    int64_t max_bin = std::min<int64_t>(0xFFFF, (int64_t)(ac * 50.0 * 3.0 + 0.5));
    int64_t b = (p - S->first_pos) / 50;
    int32_t & cnt = S->bins[s][b];
    if (cnt > max_bin)
      return false;
    cnt += 1;
    return true;
  };
  for (int64_t r = 0; r < n; ++r)
  {
    if (B.flags_v[r] & S->sam_flag_filter)
      continue;
    if (S->is_sv && B.sv_bad_v[r])
      continue;
    int64_t len = B.read_off[r + 1] - B.read_off[r];
    bool same = S->have_prev && B.pos_v[r] == S->prev_pos &&
                len == (int64_t)S->prev_codes.size() &&
                memcmp(B.read_codes.data() + B.read_off[r], S->prev_codes.data(), len) == 0;
    if (same)
    {
      if (cov_filter)
        bin_update(B.rg_v[r], B.pos_v[r]);  // duplicates update, never reject
      rep_of[r] = reps.empty() ? -1 : (int64_t)reps.size() - 1;
      S->R->num_duplicated += 1;
      S->R->num_records += 1;
      continue;
    }
    if (cov_filter && !bin_update(B.rg_v[r], B.pos_v[r]))
    {
      P.skip[r] = 1;  // prev carry unchanged, like Python's prev_key
      rep_of[r] = -2;
      continue;
    }
    reps.push_back(r);
    S->prev_pos = B.pos_v[r];
    S->prev_codes.assign(B.read_codes.begin() + B.read_off[r],
                         B.read_codes.begin() + B.read_off[r + 1]);
    S->have_prev = true;
    rep_of[r] = (int64_t)reps.size() - 1;
    S->R->num_records += 1;
  }
  return 1;
}

// Stage the next batch for the device-align pipeline: runs the stateful
// dedup, computes per-rep orientation rows (like compute_reps_rows, batch-
// local), and exports the device aligner's inputs — exact kmer keys as
// uint32 halves ([cap_rows, nk_cap]), tail codes ([cap_rows, 32]) and row
// lengths. Returns n_rows (>= 0), -1 when the stream is drained, -2 on
// spill error, -3 if cap_rows is too small (caller falls back to plain
// stepping — the batch stays queued with rows empty).
int32_t gt_stream_stage(
  void * handle,
  uint32_t * hi_out, uint32_t * lo_out, uint8_t * valid_out,
  uint8_t * tails_out, int32_t * lens_out,
  int32_t cap_rows, int32_t nk_cap)
{
  StreamCall * S = (StreamCall *)handle;
  StreamCall::PendingBatch P;
  int rc = stream_stage_one(S, P);
  if (rc <= 0)
    return rc == 0 ? -1 : -2;
  StagedBatch & B = P.B;
  int64_t n_reps = (int64_t)P.reps.size();
  P.rep_row_fwd.assign(n_reps, -1);
  P.rep_row_rc.assign(n_reps, -1);
  int64_t n_rows = 0;
  for (int64_t q = 0; q < n_reps; ++q)
  {
    int64_t r = P.reps[q];
    int len = (int)(B.read_off[r + 1] - B.read_off[r]);
    if (len < 2 * K - 1)
      continue;
    P.rep_row_fwd[q] = n_rows++;
    bool proper_geometry =
      (B.flags_v[r] & IS_PAIRED) == 0 ||
      (B.same_ref[r] && -1200 < B.tlen_v[r] && B.tlen_v[r] < 1200 &&
       ((B.flags_v[r] & 0x10) != 0) != ((B.flags_v[r] & 0x20) != 0));
    if (!proper_geometry || S->force_both)
      P.rep_row_rc[q] = n_rows++;
  }
  if (n_rows > cap_rows)
  {
    P.rep_row_fwd.clear();
    P.rep_row_rc.clear();
    S->pending_q.push_back(std::move(P));
    return -3;
  }
  // fill the device input matrices
  std::vector<uint8_t> rcodes;
  for (int64_t q = 0; q < n_reps; ++q)
  {
    for (int pass = 0; pass < 2; ++pass)
    {
      int64_t row = pass == 0 ? P.rep_row_fwd[q] : P.rep_row_rc[q];
      if (row < 0)
        continue;
      int64_t r = P.reps[q];
      const uint8_t * codes = B.read_codes.data() + B.read_off[r];
      int len = (int)(B.read_off[r + 1] - B.read_off[r]);
      if (pass == 1)
      {
        rcodes.resize(len);
        for (int i = 0; i < len; ++i)
          rcodes[i] = CODE_COMP[codes[len - 1 - i] & 15];
        codes = rcodes.data();
      }
      lens_out[row] = len;
      int nk_r = 1 + (len - K) / (K - 1);
      for (int i = 0; i < nk_cap; ++i)
      {
        int64_t o = row * nk_cap + i;
        int p = (K - 1) * i;
        if (i >= nk_r || p + K > len)
        {
          hi_out[o] = lo_out[o] = 0;
          valid_out[o] = 0;
          continue;
        }
        uint64_t key = 0;
        bool amb = false;
        for (int j = p; j < p + K; ++j)
        {
          if (codes[j] >= 4)
          {
            amb = true;
            break;
          }
          key = (key << 2) | codes[j];
        }
        hi_out[o] = amb ? 0 : (uint32_t)(key >> 32);
        lo_out[o] = amb ? 0 : (uint32_t)key;
        valid_out[o] = amb ? 0 : 1;
      }
      uint8_t * dst = tails_out + row * 32;
      memset(dst, 15, 32);
      // a read longer than nk_cap full kmers cannot be verified clean by the
      // device (its kmer matrix is truncated): leave its kmers invalid so it
      // falls back (valid_out above already handles i >= nk_cap via loop cap)
      if (nk_r <= nk_cap)
      {
        int tail_start = 31 * nk_r + 1;
        for (int i = tail_start; i < len && i - tail_start < 32; ++i)
          dst[i - tail_start] = codes[i];
      }
      else
        for (int i = 0; i < nk_cap; ++i)
          valid_out[row * nk_cap + i] = 0;
    }
  }
  S->pending_q.push_back(std::move(P));
  return (int32_t)n_rows;
}

int32_t gt_stream_step(
  void * handle,
  // graph
  const int64_t * ref_order, const int64_t * ref_dna_start, const int64_t * ref_dna_len,
  const int64_t * ref_var_first, int64_t n_ref, const uint8_t * ref_arena,
  const int64_t * var_order, const int64_t * var_dna_start, const int64_t * var_dna_len,
  const int64_t * var_out_ref, int64_t n_var, const uint8_t * var_arena,
  const int64_t * sp_ref_reach, const int64_t * sp_actual, int64_t n_special,
  // sites
  const int64_t * site_order, const int64_t * site_cnum, const uint8_t * site_is_snp,
  int64_t n_sites,
  // index
  const uint64_t * keys, int64_t n_keys, const int64_t * offsets,
  const int64_t * lab_start, const int64_t * lab_end, const int64_t * lab_var,
  // optional seed filter handle from gt_seed_filter_build (nullable)
  void * seed_filter,
  // device alignment verdicts for the PENDING batch staged by
  // gt_stream_stage ([n_rows, VERD_COLS] int32; nullable)
  const int32_t * verd_rows, int32_t verd_verify,
  int64_t * out_n_obs, int64_t * out_n_xvals)
{
  StreamCall * S = (StreamCall *)handle;
  GraphView G{ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
              var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
              sp_ref_reach, sp_actual, n_special, S->is_sv != 0};
  IndexView I{keys, n_keys, offsets, lab_start, lab_end, lab_var};
  const SeedFilter * sf = (const SeedFilter *)seed_filter;
  SiteView SV{site_order, site_cnum, site_is_snp, n_sites};

  StreamCall::PendingBatch P;
  bool from_queue = !S->pending_q.empty();
  if (from_queue)
  {
    P = std::move(S->pending_q.front());
    S->pending_q.pop_front();
  }
  else
  {
    int rc = stream_stage_one(S, P);
    if (rc <= 0)
      return rc == 0 ? 0 : -1;
    verd_rows = nullptr;  // rows were never computed for this batch
  }
  StagedBatch & B = P.B;

  auto & read_codes = B.read_codes;
  auto & names = B.names;
  auto & quals = B.quals;
  auto & same_ref = B.same_ref;
  auto & sv_bad_v = B.sv_bad_v;
  auto & read_off = B.read_off;
  auto & name_off = B.name_off;
  auto & qual_off = B.qual_off;
  auto & pos_v = B.pos_v;
  auto & flags_v = B.flags_v;
  auto & mapq_v = B.mapq_v;
  auto & tlen_v = B.tlen_v;
  auto & sdiff_v = B.sdiff_v;
  auto & clip_v = B.clip_v;
  auto & rg_v = B.rg_v;

  int64_t n = (int64_t)pos_v.size();
  int64_t prof_t1 = prof_enabled() ? prof_now() : 0;
  std::vector<int64_t> & reps = P.reps;
  std::vector<int64_t> & rep_of = P.rep_of;

  // ---- stage 1: align batch reps (parallel) ------------------------------
  int64_t prof_ta = prof_enabled() ? prof_now() : 0;
  std::vector<std::pair<Geno, Geno>> aligned(reps.size());
  {
    auto align_range = [&](size_t lo, size_t hi) {
      std::vector<uint8_t> rcodes;
      auto try_device = [&](int64_t row, const uint8_t * cp, int len, Geno & g) -> bool {
        if (verd_rows == nullptr || row < 0)
          return false;
        if (!synth_geno_from_verdict(G, verd_rows + row * VERD_COLS, len, g))
        {
          g_dal_fallback.fetch_add(1, std::memory_order_relaxed);
          return false;
        }
        if (verd_verify)
        {
          Geno ref;
          ref.read_length = len;
          find_genotype_paths(G, I, cp, len, ref, nullptr, sf);
          if (!geno_equal(g, ref))
          {
            g_dal_bad.fetch_add(1, std::memory_order_relaxed);
            g = std::move(ref);  // host result wins: correctness preserved
            return true;
          }
        }
        g_dal_clean.fetch_add(1, std::memory_order_relaxed);
        return true;
      };
      for (size_t qq = lo; qq < hi; ++qq)
      {
        int64_t r = reps[qq];
        const uint8_t * codes = read_codes.data() + read_off[r];
        int len = (int)(read_off[r + 1] - read_off[r]);
        Geno & g1 = aligned[qq].first;
        Geno & g2 = aligned[qq].second;
        g1.read_length = g2.read_length = len;
        if (len >= 2 * K - 1)
        {
          bool proper_geometry =
            (flags_v[r] & IS_PAIRED) == 0 ||
            (same_ref[r] && -1200 < tlen_v[r] && tlen_v[r] < 1200 &&
             ((flags_v[r] & 0x10) != 0) != ((flags_v[r] & 0x20) != 0));
          int64_t row1 = verd_rows != nullptr ? P.rep_row_fwd[qq] : -1;
          if (!try_device(row1, codes, len, g1))
            find_genotype_paths(G, I, codes, len, g1, nullptr, sf);
          if (!proper_geometry || S->force_both)
          {
            rcodes.resize(len);
            for (int i = 0; i < len; ++i)
              rcodes[i] = CODE_COMP[codes[len - 1 - i] & 15];
            int64_t row2 = verd_rows != nullptr ? P.rep_row_rc[qq] : -1;
            if (!try_device(row2, rcodes.data(), len, g2))
              find_genotype_paths(G, I, rcodes.data(), len, g2, nullptr, sf);
          }
        }
      }
    };
    int nt = (S->n_threads <= 1) ? 1 : std::min<int64_t>(S->n_threads, ((int64_t)reps.size() + 63) / 64);
    if (nt <= 1)
      align_range(0, reps.size());
    else
    {
      std::vector<std::thread> threads;
      size_t per = (reps.size() + nt - 1) / nt;
      for (int t = 0; t < nt; ++t)
      {
        size_t lo = t * per, hi = std::min(reps.size(), (t + 1) * per);
        if (lo >= hi)
          break;
        threads.emplace_back(align_range, lo, hi);
      }
      for (auto & th : threads)
        th.join();
    }
  }

  // ---- stage 2: replay batch per worker ----------------------------------
  int64_t prof_tb = prof_enabled() ? prof_now() : 0;
  if (prof_enabled())
    S->prof_align_ns += prof_tb - prof_ta;
  SvCtx svctx{S->is_sv ? sv_bad_v.data() : nullptr,
              S->avg_cov_store.empty() ? nullptr : S->avg_cov_store.data(),
              S->first_pos, S->depth, S->depth_ref_size, S->depth_ref_offset};
  auto stage2_batch = [&](size_t ti) {
    int32_t slo = S->ranges[ti].first, shi = S->ranges[ti].second;
    CallResult & Rw = S->parts[ti];
    CallCtx Cw{&G, &SV, S->n_samples, S->hq_reads != 0, &Rw, S->is_sv ? &svctx : nullptr};
    auto & wmaps = S->maps[ti];
    for (int64_t r = 0; r < n; ++r)
    {
      if (rep_of[r] == -2)
        continue;
      int32_t rg = rg_v[r];
      if (rg < slo || rg >= shi)
        continue;
      const auto & al = rep_of[r] >= 0 ? aligned[rep_of[r]] : S->carried_aligned;
      std::string name((const char *)names.data() + name_off[r],
                       (size_t)(name_off[r + 1] - name_off[r]));
      int32_t qlen = (int32_t)(qual_off[r + 1] - qual_off[r]);
      if (!stage2_one_record(Cw, rg, (uint32_t)flags_v[r], mapq_v[r], clip_v[r], sdiff_v[r],
                             quals.data() + qual_off[r], qlen, std::move(name), al.first,
                             al.second, wmaps[rg - slo],
                             S->is_sv ? &S->ins_counters[ti] : nullptr))
      {
        Rw.error = 1;
        return;
      }
    }
  };
  if (S->ranges.size() <= 1)
    stage2_batch(0);
  else
  {
    std::vector<std::thread> threads;
    for (size_t ti = 0; ti < S->ranges.size(); ++ti)
      threads.emplace_back(stage2_batch, ti);
    for (auto & th : threads)
      th.join();
  }

  int64_t prof_t2 = prof_enabled() ? prof_now() : 0;
  if (prof_enabled())
  {
    S->prof_stage1_ns += prof_t2 - prof_t1;
    S->prof_replay_ns += prof_t2 - prof_tb;
  }

  // carry the last rep's alignment for cross-batch dedup runs
  if (!reps.empty())
    S->carried_aligned = aligned.back();

  // ---- drain this batch's observation rows (conn/eps stay in workers) ----
  S->batch_obs = CallResult();
  for (auto & W : S->parts)
  {
    if (W.error)
      S->R->error = W.error;
    auto cat = [](auto & dst, auto & src) {
      dst.insert(dst.end(), src.begin(), src.end());
      src.clear();
    };
    CallResult & B = S->batch_obs;
    cat(B.o_site, W.o_site);
    cat(B.o_sample, W.o_sample);
    cat(B.o_eps, W.o_eps);
    cat(B.o_apply, W.o_apply);
    cat(B.o_cov, W.o_cov);
    cat(B.o_clip_scaled, W.o_clip_scaled);
    cat(B.o_clip_flag, W.o_clip_flag);
    cat(B.o_mapq_sq, W.o_mapq_sq);
    cat(B.o_mm_scaled, W.o_mm_scaled);
    cat(B.o_sdiff, W.o_sdiff);
    cat(B.o_strand, W.o_strand);
    cat(B.o_proper, W.o_proper);
    cat(B.o_bits_lo, W.o_bits_lo);
    cat(B.o_bits_hi, W.o_bits_hi);
    cat(B.o_big, W.o_big);
    cat(B.x_count, W.x_count);
    cat(B.x_vals, W.x_vals);
  }
  *out_n_obs = (int64_t)S->batch_obs.o_site.size();
  *out_n_xvals = (int64_t)S->batch_obs.x_vals.size();

  // return this batch's buffers to the rotation: the next step installs them
  // as the fill target instead of allocating tens of MB fresh per batch
  S->spare = std::move(B);
  return 1;
}

int32_t gt_stream_fetch_obs(void * handle,
                            int32_t * o_site, int32_t * o_sample, int32_t * o_eps,
                            uint8_t * o_apply, uint32_t * o_bits_lo, uint32_t * o_bits_hi,
                            int32_t * o_cov, int32_t * o_clip_scaled, uint8_t * o_clip_flag,
                            int32_t * o_mapq_sq, int32_t * o_mm_scaled, int32_t * o_sdiff,
                            uint8_t * o_strand, uint8_t * o_proper, uint8_t * o_big,
                            int32_t * x_count, uint16_t * x_vals)
{
  StreamCall * S = (StreamCall *)handle;
  CallResult & B = S->batch_obs;
  auto cp = [](auto * dst, auto const & src) {
    if (!src.empty())
      memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(o_site, B.o_site);
  cp(o_sample, B.o_sample);
  cp(o_eps, B.o_eps);
  cp(o_apply, B.o_apply);
  cp(o_bits_lo, B.o_bits_lo);
  cp(o_bits_hi, B.o_bits_hi);
  cp(o_cov, B.o_cov);
  cp(o_clip_scaled, B.o_clip_scaled);
  cp(o_clip_flag, B.o_clip_flag);
  cp(o_mapq_sq, B.o_mapq_sq);
  cp(o_mm_scaled, B.o_mm_scaled);
  cp(o_sdiff, B.o_sdiff);
  cp(o_strand, B.o_strand);
  cp(o_proper, B.o_proper);
  cp(o_big, B.o_big);
  cp(x_count, B.x_count);
  cp(x_vals, B.x_vals);
  S->batch_obs = CallResult();
  return 0;
}

// Finish: merge worker eps/conn state into the final result and hand back a
// CallResult handle compatible with gt_call_pool_fetch/free (observation
// arrays will be empty — they were drained per batch).
// Attach a staged-batch spill to an open stream (before the first step).
// mode 1 = write (iteration 2), mode 2 = replay (iteration 3+). Returns 1 on
// success; 0 means proceed without spill (caller streams from BAM as usual).
int32_t gt_stream_spill(void * handle, const char * path, int32_t mode)
{
  StreamCall * S = (StreamCall *)handle;
  if (mode == 1)
  {
    FILE * f = fopen(path, "wb");
    if (f == nullptr)
      return 0;
    setvbuf(f, nullptr, _IOFBF, 4 << 20);
    uint64_t m = SPILL_MAGIC1;
    if (fwrite(&m, 1, 8, f) != 8)
    {
      fclose(f);
      ::remove(path);
      return 0;
    }
    S->spill_w = f;
    S->spill_path = path;
    return 1;
  }
  if (mode == 2)
  {
    FILE * f = fopen(path, "rb");
    if (f == nullptr)
      return 0;
    // validate header magic and the completion trailer before trusting it
    uint64_t m = 0;
    if (fread(&m, 1, 8, f) != 8 || m != SPILL_MAGIC1 || fseek(f, -16, SEEK_END) != 0)
    {
      fclose(f);
      return 0;
    }
    uint64_t m2 = 0;
    int64_t total = -1;
    if (fread(&m2, 1, 8, f) != 8 || fread(&total, 1, 8, f) != 8 ||
        m2 != SPILL_MAGIC2 || total < 0 || fseek(f, 8, SEEK_SET) != 0)
    {
      fclose(f);
      return 0;
    }
    setvbuf(f, nullptr, _IOFBF, 4 << 20);
    S->spill_r = f;
    S->spill_expected = total;
    S->spill_path = path;
    return 1;
  }
  return 0;
}

void * gt_stream_finish(void * handle,
                        // graph (SV leftover resolution needs ref-reach)
                        const int64_t * ref_order, const int64_t * ref_dna_start,
                        const int64_t * ref_dna_len, const int64_t * ref_var_first,
                        int64_t n_ref, const uint8_t * ref_arena,
                        const int64_t * var_order, const int64_t * var_dna_start,
                        const int64_t * var_dna_len, const int64_t * var_out_ref,
                        int64_t n_var, const uint8_t * var_arena,
                        const int64_t * sp_ref_reach, const int64_t * sp_actual,
                        int64_t n_special,
                        const int64_t * site_order, const int64_t * site_cnum,
                        const uint8_t * site_is_snp, int64_t n_sites_in,
                        int64_t * out_n_obs, int64_t * out_n_xvals,
                        int64_t * out_n_conn, int64_t * out_n_counts, int64_t * out_n_touched)
{
  StreamCall * S = (StreamCall *)handle;
  if (S->prefill_active)  // early finish (error paths) can leave one staged
  {
    S->prefill.join();
    S->prefill_active = false;
  }
  if (S->spill_w != nullptr)
  {
    // the spill is only valid if it holds the COMPLETE record stream
    bool complete = S->heap.empty() && S->spill_written >= 0;
    if (complete)
    {
      uint64_t m2 = SPILL_MAGIC2;
      complete = fwrite(&m2, 1, 8, S->spill_w) == 8 &&
                 fwrite(&S->spill_written, 1, 8, S->spill_w) == 8;
    }
    int rc = fclose(S->spill_w);
    S->spill_w = nullptr;
    if (!complete || rc != 0)
      ::remove(S->spill_path.c_str());
  }
  CallResult * R = S->R;
  // SV: resolve unmatched mates from the persistent pending maps
  // (caller.py:436-447 / run_call_core's per-worker leftover pass), per
  // worker in sample order, by map insertion order
  if (S->is_sv)
  {
    GraphView G{ref_order, ref_dna_start, ref_dna_len, ref_var_first, n_ref, ref_arena,
                var_order, var_dna_start, var_dna_len, var_out_ref, n_var, var_arena,
                sp_ref_reach, sp_actual, n_special, true};
    SiteView SV{site_order, site_cnum, site_is_snp, n_sites_in};
    SvCtx svctx{nullptr, S->avg_cov_store.empty() ? nullptr : S->avg_cov_store.data(),
                S->first_pos, S->depth, S->depth_ref_size, S->depth_ref_offset};
    for (size_t ti = 0; ti < S->ranges.size(); ++ti)
    {
      CallResult & Rw = S->parts[ti];
      if (Rw.error)
        continue;
      CallCtx Cw{&G, &SV, S->n_samples, S->hq_reads != 0, &Rw, &svctx};
      int32_t slo = S->ranges[ti].first, shi = S->ranges[ti].second;
      for (int32_t rg = slo; rg < shi; ++rg)
      {
        auto & map = S->maps[ti][rg - slo];
        std::vector<const Pending *> order;
        order.reserve(map.size());
        for (auto const & kv : map)
          order.push_back(&kv.second);
        std::sort(order.begin(), order.end(),
                  [](const Pending * a, const Pending * b) { return a->ins_seq < b->ins_seq; });
        for (const Pending * p : order)
          process_leftover_mate(Cw, *p, rg);
      }
    }
  }
  if (prof_enabled())
    fprintf(stderr,
            "[gt_stream] fill=%.3fs (next=%.3fs, exposed wait=%.3fs) align+replay=%.3fs "
            "(dedup=%.3fs align=%.3fs replay=%.3fs)\n",
            S->prof_fill_ns * 1e-9, S->prof_next_ns * 1e-9, S->prof_wait_ns * 1e-9,
            S->prof_stage1_ns * 1e-9,
            (S->prof_stage1_ns - S->prof_align_ns - S->prof_replay_ns) * 1e-9,
            S->prof_align_ns * 1e-9, S->prof_replay_ns * 1e-9);
  merge_worker_parts(R, S->parts, S->ranges, S->n_sites, S->n_samples);
  R->finalize_conn();
  *out_n_obs = (int64_t)R->o_site.size();
  *out_n_xvals = (int64_t)R->x_vals.size();
  *out_n_conn = (int64_t)R->c_hap1.size();
  *out_n_counts = (int64_t)R->c_counts.size();
  *out_n_touched = (int64_t)R->t_hap1.size();
  S->R = nullptr;
  return R;
}

void gt_stream_free(void * handle)
{
  StreamCall * S = (StreamCall *)handle;
  if (S->prefill_active)
  {
    S->prefill.join();
    S->prefill_active = false;
  }
  if (S->spill_w != nullptr)  // finish never ran: incomplete spill
  {
    fclose(S->spill_w);
    ::remove(S->spill_path.c_str());
  }
  if (S->spill_r != nullptr)
    fclose(S->spill_r);
  for (auto & F : S->files)
    F.z.close_file();
  delete S->R;
  delete S;
}

}  // extern "C"
