// Native discovery first pass: the per-sample CIGAR pileup with SNP
// has_good_support and indel realignment-support gates plus the SNP
// haplotype phase analysis, consuming decompressed BAM bytes directly.
//
// Ports graphtyper_tpu/typer/discovery.py run_first_pass (reference
// semantics src/typer/caller.cpp:488-1365) and the EventSupport gates of
// typer/events.py (event.cpp:218-291). Event-level parity with the Python
// pass is asserted by tests/pipeline/test_native_first_pass.py.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

// GT_NATIVE_PROFILE=1: per-phase walls on stderr (parse/pileup/gates)
static bool fp_prof_enabled()
{
  static int v = -1;
  if (v < 0)
  {
    const char * e = getenv("GT_NATIVE_PROFILE");
    v = (e && *e && *e != '0') ? 1 : 0;
  }
  return v == 1;
}

static int64_t fp_now()
{
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
           std::chrono::steady_clock::now().time_since_epoch())
    .count();
}

constexpr int64_t BUCKET_SIZE = 50;
constexpr uint32_t FP_IS_PROPER_PAIR = 0x2;
constexpr uint32_t FP_IS_REVERSED = 0x10;
constexpr uint32_t FP_IS_FIRST_IN_PAIR = 0x40;

struct FpOpts {
  int64_t filter_on_proper_pairs;
  int64_t no_filter_on_begin_pos;
  int64_t filter_on_read_bias;
  int64_t filter_on_strand_bias;
};

// type order I < D < X at equal positions (event.cpp:173-181)
struct EvKey {
  int64_t pos;
  uint8_t type;  // 0=I 1=D 2=X
  std::string seq;

  bool operator<(const EvKey & o) const
  {
    if (pos != o.pos)
      return pos < o.pos;
    if (type != o.type)
      return type < o.type;
    return seq < o.seq;
  }
  bool operator==(const EvKey & o) const { return pos == o.pos && type == o.type && seq == o.seq; }
};

struct EvSupport {
  int64_t hq_count = 0, lq_count = 0, proper_pairs = 0, first_in_pairs = 0;
  int64_t sequence_reversed = 0, clipped = 0, max_mapq = 0, max_distance = 0;
  int64_t uniq_pos1 = -1, uniq_pos2 = -1, uniq_pos3 = -1;
  int64_t span = 1;
  bool has_realignment_support = false, has_indel_good_support = false;
  int64_t max_log_qual = 0;
  std::map<EvKey, int64_t> phase;

  int64_t raw() const { return hq_count + lq_count; }
  double corrected() const { return hq_count + lq_count / 2.0; }
};

static int64_t get_log_qual_double(double count, double anti, double eps)
{
  double gt00 = count * eps;
  double gt01 = count + anti;
  double gt11 = anti * eps;
  double gt_alt = std::min(gt01, gt11);
  return gt00 > gt_alt ? (int64_t)(gt00 - gt_alt + 0.5) : 0;
}

static bool has_good_support(const EvSupport & e, int64_t cov, const FpOpts & o)
{
  if (cov < 1)
    cov = 1;
  int64_t raw = e.raw();
  double ratio = (double)raw / (double)cov;
  bool very_promising =
    e.uniq_pos3 != -1 &&
    ((e.hq_count >= 8 && ratio >= 0.35) || (e.hq_count >= 7 && ratio >= 0.40)) &&
    (!o.filter_on_proper_pairs || e.proper_pairs >= 6);
  bool promising =
    e.uniq_pos3 != -1 &&
    ((e.hq_count >= 7 && ratio >= 0.20) || (e.hq_count >= 6 && ratio >= 0.30) ||
     (e.hq_count >= 5 && ratio >= 0.40)) &&
    (!o.filter_on_proper_pairs || e.proper_pairs >= 4);
  return (o.no_filter_on_begin_pos || e.uniq_pos2 != -1) &&
         (!o.filter_on_proper_pairs || e.proper_pairs >= 2) && (e.hq_count >= 3) &&
         (!o.filter_on_read_bias || promising ||
          (e.first_in_pairs > 0 && e.first_in_pairs < raw)) &&
         (very_promising || !o.filter_on_strand_bias ||
          (promising && e.sequence_reversed > 0 && e.sequence_reversed < raw) ||
          (e.sequence_reversed > 1 && e.sequence_reversed < raw - 1)) &&
         (e.clipped <= 1 || (e.clipped + 5) <= raw) &&
         (e.max_distance >= 10 || (promising && e.hq_count >= 10)) &&
         (e.corrected() >= 3.9) && (ratio > 0.26 || promising);
}

static int64_t compute_indel_span(const EvKey & ev, const uint8_t * ref, int64_t ref_size,
                                  int64_t ref_offset)
{
  int64_t span = 0;
  int64_t count = (int64_t)ev.seq.size();
  if (ev.type == 0)  // I
  {
    while (span < count)
    {
      if (ref_offset + span >= ref_size || (uint8_t)ev.seq[span] != ref[ref_offset + span])
        break;
      ++span;
    }
    if (span == count)
    {
      while (ref_offset + span < ref_size)
      {
        if (ref[ref_offset + span - count] != ref[ref_offset + span])
          break;
        ++span;
      }
    }
  }
  else  // D
  {
    while (ref_offset + span + count < ref_size)
    {
      if (ref[ref_offset + span] != ref[ref_offset + span + count])
        break;
      ++span;
    }
  }
  return std::min<int64_t>(span, 0xFFFE) + 1;
}

struct FpRead {
  int64_t pos;
  uint16_t flag;
  uint8_t mapq;
  std::string seq;           // ASCII
  std::vector<uint8_t> qual; // raw phred
  std::vector<std::pair<uint8_t, int32_t>> cigar;
};

static bool is_acgt(uint8_t c) { return c == 'A' || c == 'C' || c == 'G' || c == 'T'; }

struct FpResult {
  // flattened event table (all phase-time survivors, sorted enumeration)
  std::vector<EvKey> keys;
  std::vector<EvSupport> infos;
  std::vector<uint8_t> in_bucket;         // indel survivor flag
  std::vector<std::vector<int64_t>> ever; // per event: ever_together indices
  std::vector<std::vector<int64_t>> always;
  std::vector<std::vector<std::pair<int64_t, int64_t>>> phase;  // per event: (idx, count)
  int64_t n_buckets = 0;
  int32_t error = 0;
  // flattened views (filled by finalize)
  std::vector<int64_t> f_pos, f_span, f_maxlq;
  std::vector<uint8_t> f_type, f_in_bucket, f_has_good, f_has_realn;
  std::vector<int64_t> f_counts;  // 11 per event
  std::vector<uint8_t> f_seq;
  std::vector<int64_t> f_seq_off, f_ever_off, f_always_off, f_phase_off;
  std::vector<int64_t> f_ever, f_always, f_phase_idx, f_phase_cnt;

  void finalize()
  {
    int64_t n = (int64_t)keys.size();
    f_seq_off.assign(1, 0);
    f_ever_off.assign(1, 0);
    f_always_off.assign(1, 0);
    f_phase_off.assign(1, 0);
    for (int64_t i = 0; i < n; ++i)
    {
      const EvKey & k = keys[i];
      const EvSupport & e = infos[i];
      f_pos.push_back(k.pos);
      f_type.push_back(k.type);
      f_seq.insert(f_seq.end(), k.seq.begin(), k.seq.end());
      f_seq_off.push_back((int64_t)f_seq.size());
      f_span.push_back(e.span);
      f_maxlq.push_back(e.max_log_qual);
      f_in_bucket.push_back(in_bucket[i]);
      f_has_good.push_back(e.has_indel_good_support ? 1 : 0);
      f_has_realn.push_back(e.has_realignment_support ? 1 : 0);
      int64_t cs[11] = {e.hq_count, e.lq_count, e.proper_pairs, e.first_in_pairs,
                        e.sequence_reversed, e.clipped, e.max_mapq, e.max_distance,
                        e.uniq_pos1, e.uniq_pos2, e.uniq_pos3};
      f_counts.insert(f_counts.end(), cs, cs + 11);
      f_ever.insert(f_ever.end(), ever[i].begin(), ever[i].end());
      f_ever_off.push_back((int64_t)f_ever.size());
      f_always.insert(f_always.end(), always[i].begin(), always[i].end());
      f_always_off.push_back((int64_t)f_always.size());
      for (auto const & pc : phase[i])
      {
        f_phase_idx.push_back(pc.first);
        f_phase_cnt.push_back(pc.second);
      }
      f_phase_off.push_back((int64_t)f_phase_idx.size());
    }
  }
};

}  // namespace

extern "C" {

void * gt_first_pass(const uint8_t * data, int64_t size, int64_t target_ref,
                     int64_t region_begin, const uint8_t * reference, int64_t ref_size,
                     const int64_t * opt_ints,
                     int64_t * out_n_events, int64_t * out_n_seq, int64_t * out_n_ever,
                     int64_t * out_n_always, int64_t * out_n_phase, int64_t * out_n_buckets)
{
  FpResult * R = new FpResult();
  FpOpts opts{opt_ints[0], opt_ints[1], opt_ints[2], opt_ints[3]};
  int64_t prof_t0 = fp_prof_enabled() ? fp_now() : 0;

  // ---- parse reads on the target contig (position-sorted stable) ---------
  std::vector<FpRead> reads;
  if (size >= 12 && memcmp(data, "BAM\1", 4) == 0)
  {
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
    static const char NIB[17] = "=ACMGRSVTWYHKDBN";
    while (off + 4 <= size)
    {
      int32_t block_size;
      memcpy(&block_size, data + off, 4);
      if (block_size <= 0 || off + 4 + block_size > size)
        break;
      const uint8_t * p = data + off + 4;
      off += 4 + block_size;
      int32_t ref_id, pos;
      memcpy(&ref_id, p, 4);
      memcpy(&pos, p + 4, 4);
      if (ref_id < 0 || ref_id != target_ref)
        continue;
      FpRead r;
      r.pos = pos;
      uint8_t l_read_name = p[8];
      r.mapq = p[9];
      uint16_t n_cigar;
      memcpy(&n_cigar, p + 12, 2);
      memcpy(&r.flag, p + 14, 2);
      int32_t l_seq;
      memcpy(&l_seq, p + 16, 4);
      const uint8_t * q = p + 32 + l_read_name;
      for (int i = 0; i < n_cigar; ++i)
      {
        uint32_t c;
        memcpy(&c, q + 4 * i, 4);
        r.cigar.push_back({(uint8_t)(c & 0xF), (int32_t)(c >> 4)});
      }
      q += 4 * n_cigar;
      r.seq.resize(l_seq);
      for (int i = 0; i < l_seq; ++i)
        r.seq[i] = NIB[(i % 2 == 0) ? (q[i / 2] >> 4) : (q[i / 2] & 0xF)];
      q += (l_seq + 1) / 2;
      r.qual.assign(q, q + l_seq);
      reads.push_back(std::move(r));
    }
  }
  std::stable_sort(reads.begin(), reads.end(),
                   [](const FpRead & a, const FpRead & b) { return a.pos < b.pos; });
  int64_t prof_t1 = fp_prof_enabled() ? fp_now() : 0;

  // ---- pileup --------------------------------------------------------
  std::vector<int64_t> cov_up(ref_size, 0), cov_down(ref_size, 0);
  std::map<EvKey, EvSupport> events;         // all events during the pass
  std::vector<std::vector<EvKey>> bucket_events;  // bucket -> keys (for filters)
  auto bucket_of = [&](int64_t pos) { return (pos - region_begin) / BUCKET_SIZE; };

  constexpr int HIGH_EVENT_COUNT = 12;
  constexpr int VHIGH_EVENT_COUNT = 18;

  int64_t n_bucket_reads = 0;
  for (auto const & read : reads)
  {
    if (read.cigar.empty() || read.pos < region_begin)
      continue;
    int64_t ref_offset = read.pos - region_begin;
    if (ref_offset >= ref_size)
      break;
    n_bucket_reads = std::max(n_bucket_reads, ref_offset / BUCKET_SIZE + 1);

    int64_t read_offset = 0;
    bool is_read_clipped =
      (!read.cigar.empty() &&
       ((read.cigar.front().first == 4 && read.cigar.front().second >= 1) ||
        (read.cigar.back().first == 4 && read.cigar.back().second >= 1)));
    std::vector<EvSupport *> cigar_infos;
    std::vector<EvKey> cigar_keys;

    int64_t walk_offset = ref_offset;
    for (auto const & [op, cnt] : read.cigar)
    {
      if (walk_offset >= ref_size)
        break;
      if (op == 0 || op == 7 || op == 8)
      {
        for (int64_t r = 0; r < cnt; ++r)
        {
          int64_t ref_pos = walk_offset + r;
          if (ref_pos >= ref_size)
            break;
          int64_t read_pos = read_offset + r;
          if (read_pos >= (int64_t)read.seq.size())
            break;
          uint8_t ref_b = reference[ref_pos];
          uint8_t read_b = (uint8_t)read.seq[read_pos];
          if (read_b == ref_b || !is_acgt(ref_b) || !is_acgt(read_b))
            continue;
          EvKey ev{ref_pos + region_begin, 2, std::string(1, (char)read_b)};
          EvSupport & info = events[ev];
          if (read.qual[read_pos] >= 25)
            info.hq_count += 1;
          else
            info.lq_count += 1;
          if (read.mapq != 255 && read.mapq > info.max_mapq)
            info.max_mapq = read.mapq;
          info.proper_pairs += (read.flag & FP_IS_PROPER_PAIR) != 0;
          info.first_in_pairs += (read.flag & FP_IS_FIRST_IN_PAIR) != 0;
          info.sequence_reversed += (read.flag & FP_IS_REVERSED) != 0;
          info.clipped += is_read_clipped;
          if (info.uniq_pos1 == -1)
            info.uniq_pos1 = read.pos;
          else if (info.uniq_pos2 == -1)
          {
            if (info.uniq_pos1 != read.pos)
              info.uniq_pos2 = read.pos;
          }
          else if (info.uniq_pos3 == -1 && info.uniq_pos2 != read.pos)
            info.uniq_pos3 = read.pos;
          int64_t max_distance =
            std::min(read_pos, (int64_t)read.seq.size() - 1 - read_pos);
          if (max_distance > info.max_distance)
            info.max_distance = max_distance;
          cigar_infos.push_back(&info);
          cigar_keys.push_back(ev);
        }
        read_offset += cnt;
        walk_offset += cnt;
      }
      else if (op == 1)  // I
      {
        bool ok = cnt > 0;
        for (int64_t i = 0; i < cnt && ok; ++i)
          ok = is_acgt((uint8_t)read.seq[read_offset + i]);
        if (ok)
        {
          EvKey ev{region_begin + walk_offset, 0, read.seq.substr(read_offset, cnt)};
          auto it = events.find(ev);
          if (it == events.end())
          {
            it = events.emplace(ev, EvSupport()).first;
            it->second.span = compute_indel_span(ev, reference, ref_size, walk_offset);
          }
          EvSupport & info = it->second;
          info.hq_count += 1;
          if (read.mapq != 255 && read.mapq > info.max_mapq)
            info.max_mapq = read.mapq;
          info.proper_pairs += (read.flag & FP_IS_PROPER_PAIR) != 0;
          info.sequence_reversed += (read.flag & FP_IS_REVERSED) != 0;
          info.clipped += is_read_clipped;
          cigar_infos.push_back(&info);
          cigar_keys.push_back(ev);
        }
        read_offset += cnt;
      }
      else if (op == 2)  // D
      {
        if (walk_offset + cnt >= ref_size)
        {
          walk_offset += cnt;
          continue;
        }
        bool ok = true;
        for (int64_t i = 0; i < cnt && ok; ++i)
          ok = is_acgt(reference[walk_offset + i]);
        if (ok)
        {
          EvKey ev{region_begin + walk_offset, 1,
                   std::string((const char *)reference + walk_offset, cnt)};
          auto it = events.find(ev);
          if (it == events.end())
          {
            it = events.emplace(ev, EvSupport()).first;
            it->second.span = compute_indel_span(ev, reference, ref_size, walk_offset);
          }
          EvSupport & info = it->second;
          info.hq_count += 1;
          if (read.mapq != 255 && read.mapq > info.max_mapq)
            info.max_mapq = read.mapq;
          info.proper_pairs += (read.flag & FP_IS_PROPER_PAIR) != 0;
          info.sequence_reversed += (read.flag & FP_IS_REVERSED) != 0;
          info.clipped += is_read_clipped;
          cigar_infos.push_back(&info);
          cigar_keys.push_back(ev);
        }
        walk_offset += cnt;
      }
      else if (op == 4)  // S
        read_offset += cnt;
      // H/P: nothing
    }

    // demote event support on messy reads (caller.cpp:1114-1146)
    if ((int)cigar_infos.size() >= HIGH_EVENT_COUNT)
    {
      for (EvSupport * info : cigar_infos)
      {
        if ((int)cigar_infos.size() >= VHIGH_EVENT_COUNT)
        {
          if (info->hq_count > 0)
            info->hq_count -= 1;
          else if (info->lq_count > 0)
            info->lq_count -= 1;
        }
        else
        {
          if (info->hq_count > 0)
          {
            info->hq_count -= 1;
            info->lq_count += 1;
          }
        }
      }
    }
    if ((int)cigar_infos.size() < VHIGH_EVENT_COUNT)
    {
      for (size_t e = 1; e < cigar_infos.size(); ++e)
        for (size_t prev = 0; prev < e; ++prev)
          cigar_infos[prev]->phase[cigar_keys[e]] += 1;
    }

    // coverage tracks (order-free)
    int64_t ref_span = 0;
    for (auto const & [op, cnt] : read.cigar)
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        ref_span += cnt;
    int64_t end_off = std::min(ref_offset + ref_span, ref_size - 1);
    cov_up[ref_offset] += 1;
    cov_down[end_off] += 1;
  }

  // trim excess buckets like the Python pass
  int64_t NUM_BUCKETS = n_bucket_reads;
  // events can extend the bucket list in Python; mirror with event positions
  for (auto const & kv : events)
    NUM_BUCKETS = std::max(NUM_BUCKETS, bucket_of(kv.first.pos) + 1);
  if ((NUM_BUCKETS - 1) * BUCKET_SIZE >= ref_size)
    NUM_BUCKETS = (ref_size - 1) / BUCKET_SIZE + 1;
  R->n_buckets = NUM_BUCKETS;

  int64_t prof_t2 = fp_prof_enabled() ? fp_now() : 0;

  std::vector<int64_t> cum(ref_size + 1, 0);
  for (int64_t i = 0; i < ref_size; ++i)
    cum[i + 1] = cum[i] + cov_up[i] - cov_down[i];
  auto cov_at = [&](int64_t pos) { return cum[std::min(pos + 1, ref_size)]; };

  // ---- SNP filter (caller.cpp:915-990) -----------------------------------
  for (auto it = events.begin(); it != events.end();)
  {
    if (it->first.type != 2 || bucket_of(it->first.pos) >= NUM_BUCKETS)
    {
      ++it;
      continue;
    }
    int64_t begin = std::max<int64_t>(0, it->first.pos - region_begin);
    if (!has_good_support(it->second, cov_at(begin), opts))
      it = events.erase(it);
    else
      ++it;
  }

  // ---- indel gates (caller.cpp:993-1190) ---------------------------------
  for (auto it = events.begin(); it != events.end();)
  {
    const EvKey & ev = it->first;
    EvSupport & info = it->second;
    if (ev.type == 2 || bucket_of(ev.pos) >= NUM_BUCKETS)
    {
      ++it;
      continue;
    }
    int64_t naive_pad = (int64_t)(4.0 + (double)ev.seq.size() / 3.0);
    int64_t naive_begin = std::max<int64_t>(0, ev.pos - naive_pad - region_begin);
    int64_t naive_end = std::min<int64_t>(ref_size, ev.pos + info.span + naive_pad - region_begin);
    double correction = (ev.type == 0) ? ((double)ev.seq.size() / 2.0 + 8.0) / 8.0
                                       : ((double)ev.seq.size() / 3.0 + 10.0) / 10.0;
    double count = correction * (double)(info.hq_count + info.lq_count);
    int64_t cov = cum[naive_begin];
    int64_t s = std::max(bucket_of(ev.pos) * BUCKET_SIZE, naive_begin);
    int64_t end_limit = std::min(naive_end, ref_size - 1);
    if (s <= end_limit)
      for (int64_t x = s; x <= end_limit; ++x)
        cov -= cov_down[x];
    double corrected_cov = std::max((double)cov, count);
    double anti_count_d = corrected_cov - count;
    int64_t log_qual = get_log_qual_double(count, anti_count_d, 10.0);
    if (info.hq_count >= 6 && count >= 8.0 && log_qual >= 60 && info.sequence_reversed > 0 &&
        info.sequence_reversed < info.hq_count && info.proper_pairs >= 3 && info.max_mapq >= 20 &&
        (info.clipped == 0 || (info.clipped + 3) <= info.hq_count))
    {
      info.has_indel_good_support = true;
      info.has_realignment_support = true;
      info.max_log_qual = log_qual;
      ++it;
    }
    else if (count >= 3.0 && log_qual > 0 && info.proper_pairs >= 1 &&
             (info.hq_count >= 5 || info.max_mapq >= 25) && info.max_mapq >= 10 &&
             info.clipped < info.hq_count)
    {
      info.has_realignment_support = true;
      info.max_log_qual = log_qual;
      ++it;
    }
    else
      it = events.erase(it);
  }

  // drop events past the bucket range (Python never added them to buckets)
  for (auto it = events.begin(); it != events.end();)
  {
    if (bucket_of(it->first.pos) >= NUM_BUCKETS || it->first.pos < region_begin)
      it = events.erase(it);
    else
      ++it;
  }

  // ---- phase analysis (caller.cpp:1193-1360) ------------------------------
  // survivors enumerated in (bucket, sort_key) order == global sorted order
  std::vector<const EvKey *> order;
  for (auto const & kv : events)
    order.push_back(&kv.first);
  int64_t n = (int64_t)order.size();
  std::map<EvKey, int64_t> index_of;
  for (int64_t i = 0; i < n; ++i)
    index_of[*order[i]] = i;

  R->keys.resize(n);
  R->infos.resize(n);
  R->in_bucket.assign(n, 0);
  R->ever.resize(n);
  R->always.resize(n);
  R->phase.resize(n);

  for (int64_t i = 0; i < n; ++i)
  {
    const EvKey & ev = *order[i];
    const EvSupport & info = events[ev];
    int64_t begin = std::max<int64_t>(0, ev.pos - region_begin);
    int64_t cov = cov_at(begin);
    double support_ratio =
      std::max(0.3, (double)info.raw() / (double)std::max<int64_t>(cov, 1));

    for (int64_t j = 0; j < n; ++j)
    {
      const EvKey & ev2 = *order[j];
      if (ev2.pos == ev.pos && ev2.type == ev.type)
        continue;
      if (ev2.pos <= ev.pos)
        continue;
      if (ev2.pos >= ev.pos + 2 * BUCKET_SIZE)
        continue;
      // bucket window: same bucket (later events), +1, +2
      int64_t b1 = bucket_of(ev.pos), b2 = bucket_of(ev2.pos);
      if (b2 < b1 || b2 > b1 + 2)
        continue;
      if (b2 == b1 && !(ev < ev2))
        continue;
      bool is_indel = ev.type != 2 || ev2.type != 2;
      int64_t flags;
      auto ph_it = info.phase.find(ev2);
      int64_t support = ph_it == info.phase.end() ? 0 : ph_it->second;
      if (is_indel)
        flags = support == 0 ? 2 : 3;
      else
      {
        int64_t end = std::max<int64_t>(0, ev2.pos - region_begin);
        int64_t local_cov = cov;
        int64_t hi = std::min(end, ref_size - 1);
        for (int64_t x = begin + 1; x <= hi; ++x)
          local_cov -= cov_down[x];
        if (local_cov <= 2)
          flags = 0;
        else
        {
          double rr = (double)support / (double)local_cov / support_ratio;
          flags = rr < 0.22 ? 2 : (rr > 0.78 ? 1 : 3);
        }
      }
      if (flags & 1)
      {
        R->ever[i].push_back(j);
        if (ev2.pos <= ev.pos + 10)
          R->always[i].push_back(j);
      }
    }
    R->keys[i] = ev;
    R->infos[i] = info;
    R->in_bucket[i] = ev.type != 2;  // X events leave the buckets
    for (auto const & pc : info.phase)
    {
      auto f = index_of.find(pc.first);
      if (f != index_of.end())
        R->phase[i].push_back({f->second, pc.second});
    }
  }

  R->finalize();
  if (fp_prof_enabled())
  {
    int64_t t3 = fp_now();
    fprintf(stderr,
            "[gt_first_pass] reads=%lld events=%lld parse=%.3fs pileup=%.3fs gates=%.3fs\n",
            (long long)reads.size(), (long long)n, (prof_t1 - prof_t0) * 1e-9,
            (prof_t2 - prof_t1) * 1e-9, (t3 - prof_t2) * 1e-9);
  }
  *out_n_events = n;
  *out_n_seq = (int64_t)R->f_seq.size();
  *out_n_ever = (int64_t)R->f_ever.size();
  *out_n_always = (int64_t)R->f_always.size();
  *out_n_phase = (int64_t)R->f_phase_idx.size();
  *out_n_buckets = R->n_buckets;
  return R;
}

int32_t gt_first_pass_fetch(void * handle,
                            int64_t * pos, uint8_t * type, uint8_t * seq, int64_t * seq_off,
                            int64_t * counts, int64_t * span, int64_t * maxlq,
                            uint8_t * in_bucket, uint8_t * has_good, uint8_t * has_realn,
                            int64_t * ever, int64_t * ever_off,
                            int64_t * always, int64_t * always_off,
                            int64_t * phase_idx, int64_t * phase_cnt, int64_t * phase_off)
{
  FpResult * R = static_cast<FpResult *>(handle);
  if (!R)
    return -1;
  auto cp = [](auto * dst, auto const & src) {
    memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(pos, R->f_pos);
  cp(type, R->f_type);
  cp(seq, R->f_seq);
  cp(seq_off, R->f_seq_off);
  cp(counts, R->f_counts);
  cp(span, R->f_span);
  cp(maxlq, R->f_maxlq);
  cp(in_bucket, R->f_in_bucket);
  cp(has_good, R->f_has_good);
  cp(has_realn, R->f_has_realn);
  cp(ever, R->f_ever);
  cp(ever_off, R->f_ever_off);
  cp(always, R->f_always);
  cp(always_off, R->f_always_off);
  cp(phase_idx, R->f_phase_idx);
  cp(phase_cnt, R->f_phase_cnt);
  cp(phase_off, R->f_phase_off);
  return 0;
}

void gt_first_pass_free(void * handle)
{
  delete static_cast<FpResult *>(handle);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Discovery second pass: re-read the sample against the reference
// (graphtyper_tpu/typer/discovery.py read_reads_into_buckets; reference
// src/typer/caller.cpp:2232-2510 read_hts_and_return_realignment_indels).
// Parses BAM bytes, scores every read's CIGAR against the reference, and
// registers indel events — returning flat per-read arrays plus an event
// registration list the Python side replays into EventSupport state. The
// Python loop remains the oracle (tests/typer/test_native_second_pass.py).
// ---------------------------------------------------------------------------

namespace {

struct SpResult {
  std::vector<int64_t> r_pos, r_pos_end, r_seq_off;
  std::vector<int32_t> r_score, r_clip_begin, r_clip_end, r_flags, r_mapq;
  std::vector<uint8_t> r_seq;
  std::vector<int64_t> reg_read, reg_ev, reg_offset;
  std::vector<int64_t> nev_pos, nev_seq_off;
  std::vector<uint8_t> nev_type, nev_seq;
  int64_t max_read_size = 100;
};

}  // namespace

extern "C" {

void * gt_second_pass(const uint8_t * data, int64_t size, int64_t target_ref,
                      int64_t region_begin, const uint8_t * reference, int64_t ref_size,
                      // existing events (type 0=I 1=D) + realignment-support flags
                      const int64_t * ev_pos, const uint8_t * ev_type,
                      const uint8_t * ev_seq, const int64_t * ev_seq_off, int64_t n_ev,
                      const uint8_t * ev_has_realign,
                      // out sizes
                      int64_t * out_n_reads, int64_t * out_seq_bytes, int64_t * out_n_regs,
                      int64_t * out_n_new_ev, int64_t * out_new_seq_bytes,
                      int64_t * out_max_read_size)
{
  constexpr int32_t SCORE_MATCH = 1, SCORE_MISMATCH = 4, SCORE_GAP_OPEN = 7,
                    SCORE_GAP_EXTEND = 1, SCORE_CLIP = 5;
  constexpr int32_t IS_CLIPPED = 1 << 13;

  SpResult * R = new SpResult();
  R->r_seq_off.push_back(0);
  R->nev_seq_off.push_back(0);

  // event id map: provided events first, new events appended
  std::map<EvKey, int64_t> id_of;
  std::vector<char> realign;
  realign.reserve(n_ev);
  for (int64_t i = 0; i < n_ev; ++i)
  {
    EvKey k{ev_pos[i], ev_type[i],
            std::string((const char *)ev_seq + ev_seq_off[i],
                        (size_t)(ev_seq_off[i + 1] - ev_seq_off[i]))};
    id_of.emplace(std::move(k), i);
    realign.push_back(ev_has_realign[i] ? 1 : 0);
  }
  auto event_id = [&](EvKey && k) -> int64_t {
    auto it = id_of.find(k);
    if (it != id_of.end())
      return it->second;
    int64_t id = (int64_t)n_ev + (int64_t)R->nev_pos.size();
    R->nev_pos.push_back(k.pos);
    R->nev_type.push_back(k.type);
    R->nev_seq.insert(R->nev_seq.end(), k.seq.begin(), k.seq.end());
    R->nev_seq_off.push_back((int64_t)R->nev_seq.size());
    realign.push_back(0);  // fresh EventSupport: has_realignment_support=False
    id_of.emplace(std::move(k), id);
    return id;
  };

  // ---- parse + position-sort reads on the target contig ------------------
  std::vector<FpRead> reads;
  if (size >= 12 && memcmp(data, "BAM\1", 4) == 0)
  {
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
    static const char NIB[17] = "=ACMGRSVTWYHKDBN";
    while (off + 4 <= size)
    {
      int32_t block_size;
      memcpy(&block_size, data + off, 4);
      if (block_size <= 0 || off + 4 + block_size > size)
        break;
      const uint8_t * p = data + off + 4;
      off += 4 + block_size;
      int32_t ref_id, pos;
      memcpy(&ref_id, p, 4);
      memcpy(&pos, p + 4, 4);
      if (ref_id < 0 || ref_id != target_ref)
        continue;
      FpRead r;
      r.pos = pos;
      uint8_t l_read_name = p[8];
      r.mapq = p[9];
      uint16_t n_cigar;
      memcpy(&n_cigar, p + 12, 2);
      memcpy(&r.flag, p + 14, 2);
      int32_t l_seq;
      memcpy(&l_seq, p + 16, 4);
      const uint8_t * q = p + 32 + l_read_name;
      for (int i = 0; i < n_cigar; ++i)
      {
        uint32_t c;
        memcpy(&c, q + 4 * i, 4);
        r.cigar.push_back({(uint8_t)(c & 0xF), (int32_t)(c >> 4)});
      }
      q += 4 * n_cigar;
      r.seq.resize(l_seq);
      for (int i = 0; i < l_seq; ++i)
        r.seq[i] = NIB[(i % 2 == 0) ? (q[i / 2] >> 4) : (q[i / 2] & 0xF)];
      reads.push_back(std::move(r));
    }
  }
  std::stable_sort(reads.begin(), reads.end(),
                   [](const FpRead & a, const FpRead & b) { return a.pos < b.pos; });

  // ---- score + register (discovery.py read_reads_into_buckets) -----------
  for (auto const & read : reads)
  {
    if (read.cigar.empty() || read.pos < region_begin)
      continue;
    int64_t ref_offset = read.pos - region_begin;
    if (ref_offset < 0 || ref_offset >= ref_size)
      continue;
    if ((int64_t)read.seq.size() > R->max_read_size)
      R->max_read_size = (int64_t)read.seq.size();

    int64_t ridx = (int64_t)R->r_pos.size();
    int32_t score = 0, clip_b = 0, clip_e = 0;
    int32_t flags = read.flag;
    int64_t read_offset = 0;
    int64_t lseq = (int64_t)read.seq.size();

    for (size_t ci = 0; ci < read.cigar.size(); ++ci)
    {
      uint8_t op = read.cigar[ci].first;
      int64_t cnt = read.cigar[ci].second;
      if (ref_offset >= ref_size)
        break;
      if (op == 0 || op == 7 || op == 8)
      {
        int64_t n = std::min(std::min(cnt, ref_size - ref_offset), lseq - read_offset);
        for (int64_t k = 0; k < n; ++k)
        {
          uint8_t a = read.seq[read_offset + k], b = reference[ref_offset + k];
          if (a != b && a != 'N' && b != 'N')
            score -= SCORE_MISMATCH;
          else
            score += SCORE_MATCH;
        }
        read_offset += cnt;
        ref_offset += cnt;
      }
      else if (op == 1)
      {
        int64_t pl = std::max<int64_t>(0, std::min(cnt, lseq - read_offset));
        if (pl > 0)
        {
          EvKey k{region_begin + ref_offset, 0,
                  std::string(read.seq.begin() + read_offset, read.seq.begin() + read_offset + pl)};
          int64_t id = event_id(std::move(k));
          if (!realign[id])
            score -= SCORE_GAP_OPEN + (int32_t)(cnt - 1) * SCORE_GAP_EXTEND;
          else
            score += SCORE_MATCH * (int32_t)cnt;
          R->reg_read.push_back(ridx);
          R->reg_ev.push_back(id);
          R->reg_offset.push_back(read_offset);
        }
        read_offset += cnt;
      }
      else if (op == 2)
      {
        if (ref_offset + cnt >= ref_size)
          continue;  // matches the Python guard: no ref advance either
        EvKey k{region_begin + ref_offset, 1,
                std::string((const char *)reference + ref_offset, (size_t)cnt)};
        int64_t id = event_id(std::move(k));
        if (!realign[id])
          score -= SCORE_GAP_OPEN + (int32_t)(cnt - 1) * SCORE_GAP_EXTEND;
        R->reg_read.push_back(ridx);
        R->reg_ev.push_back(id);
        R->reg_offset.push_back(read_offset);
        ref_offset += cnt;
      }
      else if (op == 4)
      {
        read_offset += cnt;
        flags |= IS_CLIPPED;
        score -= SCORE_CLIP;
        if (ci == 0)
          clip_b = (int32_t)cnt;
        else
          clip_e = (int32_t)cnt;
      }
      // N/H/P: the Python loop ignores them entirely (no advance)
    }

    R->r_pos.push_back(read.pos);
    R->r_pos_end.push_back(region_begin + ref_offset);
    R->r_score.push_back(score);
    R->r_clip_begin.push_back(clip_b);
    R->r_clip_end.push_back(clip_e);
    R->r_flags.push_back(flags);
    R->r_mapq.push_back(read.mapq);
    R->r_seq.insert(R->r_seq.end(), read.seq.begin(), read.seq.end());
    R->r_seq_off.push_back((int64_t)R->r_seq.size());
  }

  *out_n_reads = (int64_t)R->r_pos.size();
  *out_seq_bytes = (int64_t)R->r_seq.size();
  *out_n_regs = (int64_t)R->reg_read.size();
  *out_n_new_ev = (int64_t)R->nev_pos.size();
  *out_new_seq_bytes = (int64_t)R->nev_seq.size();
  *out_max_read_size = R->max_read_size;
  return R;
}

int32_t gt_second_pass_fetch(void * handle,
                             int64_t * r_pos, int64_t * r_pos_end, int32_t * r_score,
                             int32_t * r_clip_begin, int32_t * r_clip_end,
                             int32_t * r_flags, int32_t * r_mapq,
                             uint8_t * r_seq, int64_t * r_seq_off,
                             int64_t * reg_read, int64_t * reg_ev, int64_t * reg_offset,
                             int64_t * nev_pos, uint8_t * nev_type,
                             uint8_t * nev_seq, int64_t * nev_seq_off)
{
  SpResult * R = static_cast<SpResult *>(handle);
  auto cp = [](auto * dst, auto const & src) {
    if (!src.empty())
      memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(r_pos, R->r_pos);
  cp(r_pos_end, R->r_pos_end);
  cp(r_score, R->r_score);
  cp(r_clip_begin, R->r_clip_begin);
  cp(r_clip_end, R->r_clip_end);
  cp(r_flags, R->r_flags);
  cp(r_mapq, R->r_mapq);
  cp(r_seq, R->r_seq);
  cp(r_seq_off, R->r_seq_off);
  cp(reg_read, R->reg_read);
  cp(reg_ev, R->reg_ev);
  cp(reg_offset, R->reg_offset);
  cp(nev_pos, R->nev_pos);
  cp(nev_type, R->nev_type);
  cp(nev_seq, R->nev_seq);
  cp(nev_seq_off, R->nev_seq_off);
  return 0;
}

void gt_second_pass_free(void * handle)
{
  delete static_cast<SpResult *>(handle);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Split first pass: extract + aggregate + gates (VERDICT r3 #2).
//
// The monolithic gt_first_pass above interleaves the CIGAR walk with the
// per-event counter updates. The split form makes the aggregation
// segment-sum shaped so it can run batched on the device at cohort scale
// (ops/discovery_pileup.py is the aggregation twin; reference analog of the
// work: src/typer/caller.cpp:488-1365):
//
//   gt_fp_extract  parse + CIGAR walk -> one row per event occurrence
//                  (dense SNP ids, no std::map on the hot path) plus
//                  host-exact messy-read demotion deltas (the one
//                  order-dependent term, resolved here like the scorer's
//                  apply_score mask), phase-pair rows, coverage tracks.
//   <aggregation>  per-event segment sums/maxes of the rows — numpy twin or
//                  the jitted device kernel, bit-identical (integer sums).
//   gt_fp_gates    the UNCHANGED SNP/indel gates + phase analysis
//                  (event.cpp:218-291 semantics) over aggregated counters;
//                  returns the same FpResult ABI as gt_first_pass.
//
// Parity: tests/pipeline/test_fp_rows.py asserts extract+aggregate+gates ==
// gt_first_pass on randomized cohorts.
// ---------------------------------------------------------------------------

namespace {

struct FpExtract {
  // event table, compact ids in creation order
  std::vector<EvKey> ev_keys;
  std::vector<int64_t> ev_span;
  // observation rows
  std::vector<int32_t> r_ev;
  std::vector<int8_t> r_dhq, r_dlq;
  std::vector<uint8_t> r_bits;   // bit0 proper, bit1 first(SNP), bit2 rev, bit3 clip
  std::vector<uint8_t> r_mapq;   // 0 when the record's mapq is 255
  std::vector<int32_t> r_dist;   // SNP: min(read_pos, len-1-read_pos); else 0
  std::vector<int64_t> r_readpos;  // SNP: read.pos; else -1
  // phase pairs (raw, one per ordered occurrence pair within a read)
  std::vector<int32_t> p_a, p_b;
  // coverage tracks + bucket count
  std::vector<int64_t> cov_up, cov_down;
  int64_t n_bucket_reads = 0;
  int64_t n_reads = 0;
  // flattened event seq bytes
  std::vector<uint8_t> ev_seq;
  std::vector<int64_t> ev_seq_off;

  void finalize()
  {
    ev_seq_off.assign(1, 0);
    for (auto const & k : ev_keys)
    {
      ev_seq.insert(ev_seq.end(), k.seq.begin(), k.seq.end());
      ev_seq_off.push_back((int64_t)ev_seq.size());
    }
  }
};

}  // namespace

extern "C" {

void * gt_fp_extract(const uint8_t * data, int64_t size, int64_t target_ref,
                     int64_t region_begin, const uint8_t * reference, int64_t ref_size,
                     int64_t * out_n_events, int64_t * out_n_seq, int64_t * out_n_rows,
                     int64_t * out_n_pairs, int64_t * out_n_bucket_reads)
{
  FpExtract * X = new FpExtract();

  // ---- parse (same walk as gt_first_pass) --------------------------------
  std::vector<FpRead> reads;
  if (size >= 12 && memcmp(data, "BAM\1", 4) == 0)
  {
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
    static const char NIB[17] = "=ACMGRSVTWYHKDBN";
    while (off + 4 <= size)
    {
      int32_t block_size;
      memcpy(&block_size, data + off, 4);
      if (block_size <= 0 || off + 4 + block_size > size)
        break;
      const uint8_t * p = data + off + 4;
      off += 4 + block_size;
      int32_t ref_id, pos;
      memcpy(&ref_id, p, 4);
      memcpy(&pos, p + 4, 4);
      if (ref_id < 0 || ref_id != target_ref)
        continue;
      FpRead r;
      r.pos = pos;
      uint8_t l_read_name = p[8];
      r.mapq = p[9];
      uint16_t n_cigar;
      memcpy(&n_cigar, p + 12, 2);
      memcpy(&r.flag, p + 14, 2);
      int32_t l_seq;
      memcpy(&l_seq, p + 16, 4);
      const uint8_t * q = p + 32 + l_read_name;
      for (int i = 0; i < n_cigar; ++i)
      {
        uint32_t c;
        memcpy(&c, q + 4 * i, 4);
        r.cigar.push_back({(uint8_t)(c & 0xF), (int32_t)(c >> 4)});
      }
      q += 4 * n_cigar;
      r.seq.resize(l_seq);
      for (int i = 0; i < l_seq; ++i)
        r.seq[i] = NIB[(i % 2 == 0) ? (q[i / 2] >> 4) : (q[i / 2] & 0xF)];
      q += (l_seq + 1) / 2;
      r.qual.assign(q, q + l_seq);
      reads.push_back(std::move(r));
    }
  }
  std::stable_sort(reads.begin(), reads.end(),
                   [](const FpRead & a, const FpRead & b) { return a.pos < b.pos; });
  X->n_reads = (int64_t)reads.size();

  // ---- extraction walk ----------------------------------------------------
  // dense SNP id table (no hashing on the dominant event type); indels via
  // an ordered map (rare). Running hq/lq per event tracked here ONLY to
  // resolve the messy-read demotion exactly (order-dependent term).
  std::vector<int32_t> snp_id((size_t)ref_size * 4, -1);
  std::map<EvKey, int32_t> indel_id;
  std::vector<int64_t> run_hq, run_lq;
  X->cov_up.assign(ref_size, 0);
  X->cov_down.assign(ref_size, 0);
  constexpr int HIGH_EVENT_COUNT = 12;
  constexpr int VHIGH_EVENT_COUNT = 18;
  int8_t base4[256];
  memset(base4, -1, sizeof(base4));
  base4[(uint8_t)'A'] = 0; base4[(uint8_t)'C'] = 1; base4[(uint8_t)'G'] = 2; base4[(uint8_t)'T'] = 3;

  std::vector<int32_t> cigar_evs;  // this read's event occurrences (compact ids)

  for (auto const & read : reads)
  {
    if (read.cigar.empty() || read.pos < region_begin)
      continue;
    int64_t ref_offset = read.pos - region_begin;
    if (ref_offset >= ref_size)
      break;
    X->n_bucket_reads = std::max(X->n_bucket_reads, ref_offset / BUCKET_SIZE + 1);

    int64_t read_offset = 0;
    bool is_read_clipped =
      (!read.cigar.empty() &&
       ((read.cigar.front().first == 4 && read.cigar.front().second >= 1) ||
        (read.cigar.back().first == 4 && read.cigar.back().second >= 1)));
    uint8_t base_bits = (uint8_t)(((read.flag & FP_IS_PROPER_PAIR) ? 1 : 0) |
                                  ((read.flag & FP_IS_REVERSED) ? 4 : 0) |
                                  (is_read_clipped ? 8 : 0));
    uint8_t first_bit = (read.flag & FP_IS_FIRST_IN_PAIR) ? 2 : 0;
    uint8_t row_mapq = read.mapq == 255 ? 0 : read.mapq;
    cigar_evs.clear();

    auto new_event = [&](EvKey && k, const uint8_t * ref, int64_t span_off, bool indel) -> int32_t {
      int32_t id = (int32_t)X->ev_keys.size();
      X->ev_span.push_back(indel ? compute_indel_span(k, ref, ref_size, span_off) : 1);
      X->ev_keys.push_back(std::move(k));
      run_hq.push_back(0);
      run_lq.push_back(0);
      return id;
    };
    auto emit = [&](int32_t id, bool hq, bool snp, int32_t dist, int64_t readpos) {
      X->r_ev.push_back(id);
      X->r_dhq.push_back(hq ? 1 : 0);
      X->r_dlq.push_back(hq ? 0 : 1);
      X->r_bits.push_back((uint8_t)(base_bits | (snp ? first_bit : 0)));
      X->r_mapq.push_back(row_mapq);
      X->r_dist.push_back(dist);
      X->r_readpos.push_back(readpos);
      if (hq)
        run_hq[id] += 1;
      else
        run_lq[id] += 1;
      cigar_evs.push_back(id);
    };

    int64_t walk_offset = ref_offset;
    for (auto const & [op, cnt] : read.cigar)
    {
      if (walk_offset >= ref_size)
        break;
      if (op == 0 || op == 7 || op == 8)
      {
        for (int64_t r = 0; r < cnt; ++r)
        {
          int64_t ref_pos = walk_offset + r;
          if (ref_pos >= ref_size)
            break;
          int64_t read_pos = read_offset + r;
          if (read_pos >= (int64_t)read.seq.size())
            break;
          uint8_t ref_b = reference[ref_pos];
          uint8_t read_b = (uint8_t)read.seq[read_pos];
          if (read_b == ref_b || !is_acgt(ref_b) || !is_acgt(read_b))
            continue;
          int8_t b4 = base4[read_b];
          int32_t & slot = snp_id[(size_t)ref_pos * 4 + b4];
          if (slot < 0)
            slot = new_event(EvKey{ref_pos + region_begin, 2, std::string(1, (char)read_b)},
                             reference, ref_pos, false);
          int32_t dist = (int32_t)std::min(read_pos, (int64_t)read.seq.size() - 1 - read_pos);
          emit(slot, read.qual[read_pos] >= 25, true, dist, read.pos);
        }
        read_offset += cnt;
        walk_offset += cnt;
      }
      else if (op == 1)  // I
      {
        bool ok = cnt > 0;
        for (int64_t i = 0; i < cnt && ok; ++i)
          ok = is_acgt((uint8_t)read.seq[read_offset + i]);
        if (ok)
        {
          EvKey k{region_begin + walk_offset, 0, read.seq.substr(read_offset, cnt)};
          auto it = indel_id.find(k);
          int32_t id;
          if (it == indel_id.end())
          {
            id = new_event(std::move(k), reference, walk_offset, true);
            indel_id.emplace(X->ev_keys.back(), id);
          }
          else
            id = it->second;
          emit(id, true, false, 0, -1);
        }
        read_offset += cnt;
      }
      else if (op == 2)  // D
      {
        if (walk_offset + cnt >= ref_size)
        {
          walk_offset += cnt;
          continue;
        }
        bool ok = true;
        for (int64_t i = 0; i < cnt && ok; ++i)
          ok = is_acgt(reference[walk_offset + i]);
        if (ok)
        {
          EvKey k{region_begin + walk_offset, 1,
                  std::string((const char *)reference + walk_offset, cnt)};
          auto it = indel_id.find(k);
          int32_t id;
          if (it == indel_id.end())
          {
            id = new_event(std::move(k), reference, walk_offset, true);
            indel_id.emplace(X->ev_keys.back(), id);
          }
          else
            id = it->second;
          emit(id, true, false, 0, -1);
        }
        walk_offset += cnt;
      }
      else if (op == 4)  // S
        read_offset += cnt;
    }

    // messy-read demotion (caller.cpp:1114-1146) against the RUNNING totals,
    // emitted as adjustment rows so the downstream sums stay order-free
    if ((int)cigar_evs.size() >= HIGH_EVENT_COUNT)
    {
      for (int32_t id : cigar_evs)
      {
        int8_t dhq = 0, dlq = 0;
        if ((int)cigar_evs.size() >= VHIGH_EVENT_COUNT)
        {
          if (run_hq[id] > 0)
            dhq = -1;
          else if (run_lq[id] > 0)
            dlq = -1;
        }
        else
        {
          if (run_hq[id] > 0)
          {
            dhq = -1;
            dlq = 1;
          }
        }
        if (dhq || dlq)
        {
          X->r_ev.push_back(id);
          X->r_dhq.push_back(dhq);
          X->r_dlq.push_back(dlq);
          X->r_bits.push_back(0);
          X->r_mapq.push_back(0);
          X->r_dist.push_back(0);
          X->r_readpos.push_back(-1);
          run_hq[id] += dhq;
          run_lq[id] += dlq;
        }
      }
    }
    if ((int)cigar_evs.size() < VHIGH_EVENT_COUNT)
    {
      for (size_t e = 1; e < cigar_evs.size(); ++e)
        for (size_t prev = 0; prev < e; ++prev)
        {
          X->p_a.push_back(cigar_evs[prev]);
          X->p_b.push_back(cigar_evs[e]);
        }
    }

    // coverage tracks (order-free)
    int64_t ref_span = 0;
    for (auto const & [op, cnt] : read.cigar)
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        ref_span += cnt;
    int64_t end_off = std::min(ref_offset + ref_span, ref_size - 1);
    X->cov_up[ref_offset] += 1;
    X->cov_down[end_off] += 1;
  }

  X->finalize();
  *out_n_events = (int64_t)X->ev_keys.size();
  *out_n_seq = (int64_t)X->ev_seq.size();
  *out_n_rows = (int64_t)X->r_ev.size();
  *out_n_pairs = (int64_t)X->p_a.size();
  *out_n_bucket_reads = X->n_bucket_reads;
  return X;
}

int32_t gt_fp_extract_fetch(void * handle,
                            int64_t * ev_pos, uint8_t * ev_type, uint8_t * ev_seq,
                            int64_t * ev_seq_off, int64_t * ev_span,
                            int32_t * r_ev, int8_t * r_dhq, int8_t * r_dlq, uint8_t * r_bits,
                            uint8_t * r_mapq, int32_t * r_dist, int64_t * r_readpos,
                            int32_t * p_a, int32_t * p_b,
                            int64_t * cov_up, int64_t * cov_down)
{
  FpExtract * X = static_cast<FpExtract *>(handle);
  if (!X)
    return -1;
  for (size_t i = 0; i < X->ev_keys.size(); ++i)
  {
    ev_pos[i] = X->ev_keys[i].pos;
    ev_type[i] = X->ev_keys[i].type;
  }
  auto cp = [](auto * dst, auto const & src) {
    if (!src.empty())
      memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(ev_seq, X->ev_seq);
  cp(ev_seq_off, X->ev_seq_off);
  cp(ev_span, X->ev_span);
  cp(r_ev, X->r_ev);
  cp(r_dhq, X->r_dhq);
  cp(r_dlq, X->r_dlq);
  cp(r_bits, X->r_bits);
  cp(r_mapq, X->r_mapq);
  cp(r_dist, X->r_dist);
  cp(r_readpos, X->r_readpos);
  cp(p_a, X->p_a);
  cp(p_b, X->p_b);
  cp(cov_up, X->cov_up);
  cp(cov_down, X->cov_down);
  return 0;
}

void gt_fp_extract_free(void * handle)
{
  delete static_cast<FpExtract *>(handle);
}

// Gates + phase analysis over externally aggregated per-event counters.
// counters layout per event (int64 x 11, the EvSupport order of
// gt_first_pass_fetch): hq, lq, proper, first, reversed, clipped, max_mapq,
// max_distance, uniq_pos1, uniq_pos2, uniq_pos3.
// pairs: (pa, pb) -> count, compacted (unique pairs).
void * gt_fp_gates(int64_t n_events, const int64_t * ev_pos, const uint8_t * ev_type,
                   const uint8_t * ev_seq, const int64_t * ev_seq_off, const int64_t * ev_span,
                   const int64_t * counters,
                   const int32_t * pa, const int32_t * pb, const int64_t * pcount,
                   int64_t n_pairs,
                   const int64_t * cov_up, const int64_t * cov_down,
                   int64_t n_bucket_reads, int64_t region_begin, int64_t ref_size,
                   const int64_t * opt_ints,
                   int64_t * out_n_events, int64_t * out_n_seq, int64_t * out_n_ever,
                   int64_t * out_n_always, int64_t * out_n_phase, int64_t * out_n_buckets)
{
  FpResult * R = new FpResult();
  FpOpts opts{opt_ints[0], opt_ints[1], opt_ints[2], opt_ints[3]};

  // rebuild the event map from the aggregated inputs
  std::vector<EvKey> keys(n_events);
  std::map<EvKey, EvSupport> events;
  for (int64_t i = 0; i < n_events; ++i)
  {
    keys[i] = EvKey{ev_pos[i], ev_type[i],
                    std::string((const char *)ev_seq + ev_seq_off[i],
                                (size_t)(ev_seq_off[i + 1] - ev_seq_off[i]))};
    EvSupport e;
    const int64_t * c = counters + i * 11;
    e.hq_count = c[0];
    e.lq_count = c[1];
    e.proper_pairs = c[2];
    e.first_in_pairs = c[3];
    e.sequence_reversed = c[4];
    e.clipped = c[5];
    e.max_mapq = c[6];
    e.max_distance = c[7];
    e.uniq_pos1 = c[8];
    e.uniq_pos2 = c[9];
    e.uniq_pos3 = c[10];
    e.span = ev_span[i];
    events.emplace(keys[i], std::move(e));
  }
  for (int64_t k = 0; k < n_pairs; ++k)
  {
    auto it = events.find(keys[pa[k]]);
    if (it != events.end())
      it->second.phase[keys[pb[k]]] += pcount[k];
  }

  auto bucket_of = [&](int64_t pos) { return (pos - region_begin) / BUCKET_SIZE; };
  int64_t NUM_BUCKETS = n_bucket_reads;
  for (auto const & kv : events)
    NUM_BUCKETS = std::max(NUM_BUCKETS, bucket_of(kv.first.pos) + 1);
  if ((NUM_BUCKETS - 1) * BUCKET_SIZE >= ref_size)
    NUM_BUCKETS = (ref_size - 1) / BUCKET_SIZE + 1;
  R->n_buckets = NUM_BUCKETS;

  std::vector<int64_t> cum(ref_size + 1, 0);
  for (int64_t i = 0; i < ref_size; ++i)
    cum[i + 1] = cum[i] + cov_up[i] - cov_down[i];
  auto cov_at = [&](int64_t pos) { return cum[std::min(pos + 1, ref_size)]; };

  // ---- SNP filter (caller.cpp:915-990) — unchanged semantics -------------
  for (auto it = events.begin(); it != events.end();)
  {
    if (it->first.type != 2 || bucket_of(it->first.pos) >= NUM_BUCKETS)
    {
      ++it;
      continue;
    }
    int64_t begin = std::max<int64_t>(0, it->first.pos - region_begin);
    if (!has_good_support(it->second, cov_at(begin), opts))
      it = events.erase(it);
    else
      ++it;
  }

  // ---- indel gates (caller.cpp:993-1190) — unchanged semantics -----------
  for (auto it = events.begin(); it != events.end();)
  {
    const EvKey & ev = it->first;
    EvSupport & info = it->second;
    if (ev.type == 2 || bucket_of(ev.pos) >= NUM_BUCKETS)
    {
      ++it;
      continue;
    }
    int64_t naive_pad = (int64_t)(4.0 + (double)ev.seq.size() / 3.0);
    int64_t naive_begin = std::max<int64_t>(0, ev.pos - naive_pad - region_begin);
    int64_t naive_end = std::min<int64_t>(ref_size, ev.pos + info.span + naive_pad - region_begin);
    double correction = (ev.type == 0) ? ((double)ev.seq.size() / 2.0 + 8.0) / 8.0
                                       : ((double)ev.seq.size() / 3.0 + 10.0) / 10.0;
    double count = correction * (double)(info.hq_count + info.lq_count);
    int64_t cov = cum[naive_begin];
    int64_t s = std::max(bucket_of(ev.pos) * BUCKET_SIZE, naive_begin);
    int64_t end_limit = std::min(naive_end, ref_size - 1);
    if (s <= end_limit)
      for (int64_t x = s; x <= end_limit; ++x)
        cov -= cov_down[x];
    double corrected_cov = std::max((double)cov, count);
    double anti_count_d = corrected_cov - count;
    int64_t log_qual = get_log_qual_double(count, anti_count_d, 10.0);
    if (info.hq_count >= 6 && count >= 8.0 && log_qual >= 60 && info.sequence_reversed > 0 &&
        info.sequence_reversed < info.hq_count && info.proper_pairs >= 3 && info.max_mapq >= 20 &&
        (info.clipped == 0 || (info.clipped + 3) <= info.hq_count))
    {
      info.has_indel_good_support = true;
      info.has_realignment_support = true;
      info.max_log_qual = log_qual;
      ++it;
    }
    else if (count >= 3.0 && log_qual > 0 && info.proper_pairs >= 1 &&
             (info.hq_count >= 5 || info.max_mapq >= 25) && info.max_mapq >= 10 &&
             info.clipped < info.hq_count)
    {
      info.has_realignment_support = true;
      info.max_log_qual = log_qual;
      ++it;
    }
    else
      it = events.erase(it);
  }

  for (auto it = events.begin(); it != events.end();)
  {
    if (bucket_of(it->first.pos) >= NUM_BUCKETS || it->first.pos < region_begin)
      it = events.erase(it);
    else
      ++it;
  }

  // ---- phase analysis (caller.cpp:1193-1360) — unchanged semantics -------
  std::vector<const EvKey *> order;
  for (auto const & kv : events)
    order.push_back(&kv.first);
  int64_t n = (int64_t)order.size();
  std::map<EvKey, int64_t> index_of;
  for (int64_t i = 0; i < n; ++i)
    index_of[*order[i]] = i;

  R->keys.resize(n);
  R->infos.resize(n);
  R->in_bucket.assign(n, 0);
  R->ever.resize(n);
  R->always.resize(n);
  R->phase.resize(n);

  for (int64_t i = 0; i < n; ++i)
  {
    const EvKey & ev = *order[i];
    const EvSupport & info = events[ev];
    int64_t begin = std::max<int64_t>(0, ev.pos - region_begin);
    int64_t cov = cov_at(begin);
    double support_ratio =
      std::max(0.3, (double)info.raw() / (double)std::max<int64_t>(cov, 1));

    for (int64_t j = 0; j < n; ++j)
    {
      const EvKey & ev2 = *order[j];
      if (ev2.pos == ev.pos && ev2.type == ev.type)
        continue;
      if (ev2.pos <= ev.pos)
        continue;
      if (ev2.pos >= ev.pos + 2 * BUCKET_SIZE)
        continue;
      int64_t b1 = bucket_of(ev.pos), b2 = bucket_of(ev2.pos);
      if (b2 < b1 || b2 > b1 + 2)
        continue;
      if (b2 == b1 && !(ev < ev2))
        continue;
      bool is_indel = ev.type != 2 || ev2.type != 2;
      int64_t flags;
      auto ph_it = info.phase.find(ev2);
      int64_t support = ph_it == info.phase.end() ? 0 : ph_it->second;
      if (is_indel)
        flags = support == 0 ? 2 : 3;
      else
      {
        int64_t end = std::max<int64_t>(0, ev2.pos - region_begin);
        int64_t local_cov = cov;
        int64_t hi = std::min(end, ref_size - 1);
        for (int64_t x = begin + 1; x <= hi; ++x)
          local_cov -= cov_down[x];
        if (local_cov <= 2)
          flags = 0;
        else
        {
          double rr = (double)support / (double)local_cov / support_ratio;
          flags = rr < 0.22 ? 2 : (rr > 0.78 ? 1 : 3);
        }
      }
      if (flags & 1)
      {
        R->ever[i].push_back(j);
        if (ev2.pos <= ev.pos + 10)
          R->always[i].push_back(j);
      }
    }
    R->keys[i] = ev;
    R->infos[i] = info;
    R->in_bucket[i] = ev.type != 2;
    for (auto const & pc : info.phase)
    {
      auto f = index_of.find(pc.first);
      if (f != index_of.end())
        R->phase[i].push_back({f->second, pc.second});
    }
  }

  R->finalize();
  *out_n_events = n;
  *out_n_seq = (int64_t)R->f_seq.size();
  *out_n_ever = (int64_t)R->f_ever.size();
  *out_n_always = (int64_t)R->f_always.size();
  *out_n_phase = (int64_t)R->f_phase_idx.size();
  *out_n_buckets = R->n_buckets;
  return R;
}

}  // extern "C"
