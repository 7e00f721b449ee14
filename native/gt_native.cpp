// Native host runtime for graphtyper_tpu: BGZF decompression and BAM record
// decoding into packed arrays ready for numpy/JAX ingestion.
//
// This replaces the reference's htslib decode path (hts_reader.cpp) with a
// from-scratch implementation tuned for batch output: one pass over the BAM
// produces flat arrays (pos/flag/mapq/... + a padded 2-bit-codable sequence
// matrix + CSR cigars) instead of per-record objects.
//
// Exposed as a C ABI for ctypes. Build: make -C native
//
// libdeflate does the deflate work when the Makefile finds it
// (GT_HAVE_LIBDEFLATE); otherwise the few libdeflate calls below are served
// by zlib with the same contract (the compressed bytes differ, the
// decompressed ones do not).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

#ifdef GT_HAVE_LIBDEFLATE
#include <libdeflate.h>
#else
#include <zlib.h>

enum libdeflate_result
{
  LIBDEFLATE_SUCCESS = 0,
  LIBDEFLATE_BAD_DATA = 1,
  LIBDEFLATE_SHORT_OUTPUT = 2,
  LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_compressor
{
  int level;
};

struct libdeflate_decompressor
{
  z_stream zs;
};

static libdeflate_compressor * libdeflate_alloc_compressor(int level)
{
  return new libdeflate_compressor{level};
}

static void libdeflate_free_compressor(libdeflate_compressor * c) { delete c; }

static size_t libdeflate_deflate_compress_bound(libdeflate_compressor *, size_t n)
{
  return compressBound(static_cast<uLong>(n));
}

// raw deflate of one buffer; returns the compressed size, 0 if it does not fit
static size_t libdeflate_deflate_compress(libdeflate_compressor * c, void const * in, size_t n,
                                          void * out, size_t avail)
{
  z_stream zs{};
  if (deflateInit2(&zs, c->level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return 0;
  zs.next_in = static_cast<Bytef *>(const_cast<void *>(in));
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = static_cast<Bytef *>(out);
  zs.avail_out = static_cast<uInt>(avail);
  int rc = deflate(&zs, Z_FINISH);
  size_t done = zs.total_out;
  deflateEnd(&zs);
  return rc == Z_STREAM_END ? done : 0;
}

static uint32_t libdeflate_crc32(uint32_t crc, void const * buf, size_t n)
{
  return static_cast<uint32_t>(crc32(crc, static_cast<Bytef const *>(buf), static_cast<uInt>(n)));
}

static libdeflate_decompressor * libdeflate_alloc_decompressor()
{
  return new libdeflate_decompressor{};
}

static void libdeflate_free_decompressor(libdeflate_decompressor * d) { delete d; }

// one gzip member from `in`: sizes consumed and produced come back through
// actual_in / actual_out (either may be null)
static libdeflate_result libdeflate_gzip_decompress_ex(libdeflate_decompressor * d,
                                                       void const * in, size_t in_n, void * out,
                                                       size_t out_avail, size_t * actual_in,
                                                       size_t * actual_out)
{
  z_stream & zs = d->zs;
  zs = z_stream{};
  if (inflateInit2(&zs, 16 + 15) != Z_OK)
    return LIBDEFLATE_BAD_DATA;
  zs.next_in = static_cast<Bytef *>(const_cast<void *>(in));
  zs.avail_in = static_cast<uInt>(in_n);
  zs.next_out = static_cast<Bytef *>(out);
  zs.avail_out = static_cast<uInt>(out_avail);
  int rc = inflate(&zs, Z_FINISH);
  if (actual_in)
    *actual_in = zs.total_in;
  if (actual_out)
    *actual_out = zs.total_out;
  inflateEnd(&zs);
  if (rc == Z_STREAM_END)
    return LIBDEFLATE_SUCCESS;
  return rc == Z_BUF_ERROR && zs.avail_out == 0 ? LIBDEFLATE_INSUFFICIENT_SPACE
                                                : LIBDEFLATE_BAD_DATA;
}
#endif

#include <atomic>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Compress `in` into BGZF members of <= 0xFF00 uncompressed bytes each,
// fanning blocks out over `n_threads` libdeflate compressors (the native
// replacement for the reference's bgzf writer threads, vcf.cpp
// open_for_writing). Returns total output size, or -1 if out_capacity is too
// small. Call with out=nullptr to get a safe capacity bound.
int64_t gt_bgzf_compress(uint8_t const * in, int64_t in_size, int32_t level, int32_t n_threads,
                         uint8_t * out, int64_t out_capacity)
{
  constexpr int64_t BLOCK = 0xFF00;
  int64_t n_blocks = (in_size + BLOCK - 1) / BLOCK;
  if (in_size == 0)
    n_blocks = 0;
  // worst case per block from libdeflate + 26 bytes bgzf wrapper
  int64_t per_block_bound = (int64_t)libdeflate_deflate_compress_bound(nullptr, BLOCK);
  int64_t bound = n_blocks * (per_block_bound + 26) + 28;
  if (out == nullptr)
    return bound;
  if (out_capacity < bound)
    return -1;

  std::vector<int64_t> sizes(n_blocks, 0);
  std::vector<std::vector<uint8_t>> parts(n_blocks);

  auto compress_range = [&](int64_t lo, int64_t hi) {
    struct libdeflate_compressor * comp = libdeflate_alloc_compressor(level <= 0 ? 6 : level);
    for (int64_t b = lo; b < hi; ++b)
    {
      int64_t off = b * BLOCK;
      int64_t len = std::min<int64_t>(BLOCK, in_size - off);
      std::vector<uint8_t> & blk = parts[b];
      blk.resize(libdeflate_deflate_compress_bound(comp, len) + 26);
      size_t csz = libdeflate_deflate_compress(comp, in + off, len, blk.data() + 18, blk.size() - 26);
      uint32_t crc = libdeflate_crc32(0, in + off, len);
      uint16_t bsize = (uint16_t)(csz + 26 - 1);
      uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                         6, 0, 'B', 'C', 2, 0,
                         (uint8_t)(bsize & 0xff), (uint8_t)(bsize >> 8)};
      memcpy(blk.data(), hdr, 18);
      uint8_t * foot = blk.data() + 18 + csz;
      memcpy(foot, &crc, 4);
      uint32_t isize = (uint32_t)len;
      memcpy(foot + 4, &isize, 4);
      sizes[b] = 18 + (int64_t)csz + 8;
      blk.resize(sizes[b]);
    }
    libdeflate_free_compressor(comp);
  };

  int nt = n_threads > 1 ? std::min<int64_t>(n_threads, n_blocks) : 1;
  if (nt <= 1)
  {
    compress_range(0, n_blocks);
  }
  else
  {
    std::vector<std::thread> threads;
    int64_t per = (n_blocks + nt - 1) / nt;
    for (int t = 0; t < nt; ++t)
    {
      int64_t lo = t * per, hi = std::min<int64_t>(n_blocks, (t + 1) * per);
      if (lo >= hi)
        break;
      threads.emplace_back(compress_range, lo, hi);
    }
    for (auto & th : threads)
      th.join();
  }

  int64_t w = 0;
  for (int64_t b = 0; b < n_blocks; ++b)
  {
    memcpy(out + w, parts[b].data(), sizes[b]);
    w += sizes[b];
  }
  return w;
}

// Decompress a whole BGZF/gzip file buffer (concatenated members).
// Returns total decompressed size, or -1 on error. If out==nullptr, only
// sizes the output (two-pass usage).
int64_t gt_bgzf_decompress(uint8_t const * in, int64_t in_size, uint8_t * out, int64_t out_capacity)
{
  struct libdeflate_decompressor * dec = libdeflate_alloc_decompressor();
  int64_t in_off = 0;
  int64_t out_off = 0;

  while (in_off < in_size)
  {
    if (in_size - in_off < 18)
      break; // trailing garbage / EOF marker boundary

    size_t actual_in = 0;
    size_t actual_out = 0;
    uint8_t * out_ptr = out ? out + out_off : nullptr;
    size_t out_avail = out ? static_cast<size_t>(out_capacity - out_off) : 0;

    if (out == nullptr)
    {
      // size-only pass: read ISIZE from BGZF BC field walk. For arbitrary
      // gzip members we must decompress; use a scratch buffer.
      // Try BGZF fast path: BC extra subfield gives compressed block size.
      if (in[in_off + 3] & 4)
      {
        uint16_t xlen;
        memcpy(&xlen, in + in_off + 10, 2);
        int64_t extra_off = in_off + 12;
        int64_t bsize = -1;
        int64_t x = 0;
        while (x + 4 <= xlen)
        {
          uint8_t si1 = in[extra_off + x], si2 = in[extra_off + x + 1];
          uint16_t slen;
          memcpy(&slen, in + extra_off + x + 2, 2);
          if (si1 == 66 && si2 == 67 && slen == 2)
          {
            uint16_t bs;
            memcpy(&bs, in + extra_off + x + 4, 2);
            bsize = static_cast<int64_t>(bs) + 1;
          }
          x += 4 + slen;
        }
        if (bsize > 0)
        {
          uint32_t isize;
          memcpy(&isize, in + in_off + bsize - 4, 4);
          out_off += isize;
          in_off += bsize;
          continue;
        }
      }
      // no BC field: bail to error (caller should use python fallback)
      libdeflate_free_decompressor(dec);
      return -2;
    }

    libdeflate_result r = libdeflate_gzip_decompress_ex(
      dec, in + in_off, static_cast<size_t>(in_size - in_off), out_ptr, out_avail, &actual_in, &actual_out);

    if (r != LIBDEFLATE_SUCCESS)
    {
      libdeflate_free_decompressor(dec);
      return -1;
    }

    in_off += static_cast<int64_t>(actual_in);
    out_off += static_cast<int64_t>(actual_out);
  }

  libdeflate_free_decompressor(dec);
  return out_off;
}

// Threaded whole-file BGZF decompression: scan member headers for the BC
// (compressed size) and trailing ISIZE fields to precompute every block's
// input/output offset, then inflate blocks in parallel. Returns total
// decompressed size, -2 when a member lacks the BGZF BC field (caller falls
// back to the serial path), -1 on inflate error.
int64_t gt_bgzf_decompress_mt(
  uint8_t const * in, int64_t in_size, uint8_t * out, int64_t out_capacity, int32_t n_threads)
{
  struct Blk
  {
    int64_t in_off;
    int64_t bsize;
    int64_t out_off;
    uint32_t isize;
  };
  std::vector<Blk> blocks;
  int64_t in_off = 0;
  int64_t out_off = 0;
  while (in_off < in_size)
  {
    if (in_size - in_off < 18)
      break;
    if (!(in[in_off + 3] & 4))
      return -2;
    uint16_t xlen;
    memcpy(&xlen, in + in_off + 10, 2);
    int64_t extra_off = in_off + 12;
    int64_t bsize = -1;
    int64_t x = 0;
    while (x + 4 <= xlen)
    {
      uint8_t si1 = in[extra_off + x], si2 = in[extra_off + x + 1];
      uint16_t slen;
      memcpy(&slen, in + extra_off + x + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2)
      {
        uint16_t bs;
        memcpy(&bs, in + extra_off + x + 4, 2);
        bsize = static_cast<int64_t>(bs) + 1;
      }
      x += 4 + slen;
    }
    if (bsize <= 0 || in_off + bsize > in_size)
      return -2;
    uint32_t isize;
    memcpy(&isize, in + in_off + bsize - 4, 4);
    if (out && out_off + static_cast<int64_t>(isize) > out_capacity)
      return -1;
    blocks.push_back({in_off, bsize, out_off, isize});
    out_off += isize;
    in_off += bsize;
  }
  if (out == nullptr)
    return out_off;

  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  auto work = [&]() {
    struct libdeflate_decompressor * dec = libdeflate_alloc_decompressor();
    for (;;)
    {
      int64_t b = next.fetch_add(1);
      if (b >= static_cast<int64_t>(blocks.size()) || failed.load(std::memory_order_relaxed))
        break;
      Blk const & blk = blocks[b];
      if (blk.isize == 0)
        continue;
      size_t actual_out = 0;
      libdeflate_result r = libdeflate_gzip_decompress_ex(dec,
                                                          in + blk.in_off,
                                                          static_cast<size_t>(blk.bsize),
                                                          out + blk.out_off,
                                                          static_cast<size_t>(blk.isize),
                                                          nullptr,
                                                          &actual_out);
      if (r != LIBDEFLATE_SUCCESS || actual_out != blk.isize)
      {
        failed.store(true, std::memory_order_relaxed);
        break;
      }
    }
    libdeflate_free_decompressor(dec);
  };
  int nt = n_threads;
  if (nt <= 0)
    nt = static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min<int>(nt, static_cast<int>(blocks.size())));
  if (nt <= 1)
    work();
  else
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back(work);
    for (auto & th : threads)
      th.join();
  }
  return failed.load() ? -1 : out_off;
}

// ---------------------------------------------------------------------------
// BAM decoding
// ---------------------------------------------------------------------------

// First pass over decompressed BAM data: counts records and measures sizes.
// Returns 0 on success. header_end receives the byte offset where alignment
// records start; n_records, max_qlen, total_cigar_ops are outputs.
int32_t gt_bam_scan(uint8_t const * data,
                    int64_t size,
                    int64_t * header_end,
                    int64_t * n_records,
                    int64_t * max_qlen,
                    int64_t * total_cigar_ops,
                    int64_t * total_name_bytes)
{
  if (size < 12 || memcmp(data, "BAM\1", 4) != 0)
    return -1;

  int32_t l_text;
  memcpy(&l_text, data + 4, 4);
  int64_t off = 8 + l_text;
  int32_t n_ref;
  memcpy(&n_ref, data + off, 4);
  off += 4;

  for (int32_t i = 0; i < n_ref; ++i)
  {
    int32_t l_name;
    memcpy(&l_name, data + off, 4);
    off += 4 + l_name + 4;
  }

  *header_end = off;
  int64_t n = 0, mq = 0, tc = 0, tn = 0;

  while (off + 4 <= size)
  {
    int32_t block_size;
    memcpy(&block_size, data + off, 4);
    if (block_size <= 0 || off + 4 + block_size > size)
      break;
    uint8_t l_read_name = data[off + 4 + 8];
    uint16_t n_cigar;
    memcpy(&n_cigar, data + off + 4 + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, data + off + 4 + 16, 4);
    ++n;
    if (l_seq > mq)
      mq = l_seq;
    tc += n_cigar;
    tn += l_read_name; // includes NUL
    off += 4 + block_size;
  }

  *n_records = n;
  *max_qlen = mq;
  *total_cigar_ops = tc;
  *total_name_bytes = tn;
  return 0;
}

// Second pass: fill caller-allocated arrays.
//  seqs:   [n_records * seq_stride] uint8 codes, pad=5 (A0 C1 G2 T3 N4)
//  quals:  [n_records * seq_stride]
//  cigars: ops uint8 + lens int32 CSR with offsets[n_records+1]
int32_t gt_bam_fill(uint8_t const * data,
                    int64_t size,
                    int64_t records_start,
                    int64_t seq_stride,
                    int32_t * ref_id,
                    int64_t * pos,
                    uint16_t * flag,
                    uint8_t * mapq,
                    int32_t * mate_ref_id,
                    int64_t * mate_pos,
                    int32_t * tlen,
                    int32_t * qlen,
                    uint8_t * seqs,
                    uint8_t * quals,
                    uint8_t * cigar_ops,
                    int32_t * cigar_lens,
                    int64_t * cigar_offsets,
                    uint8_t * names,
                    int64_t * name_offsets)
{
  // 4-bit nibble -> our code (=ACMGRSVTWYHKDBN -> pad/A/C/N/G/N/N/N/T/...)
  static uint8_t const NIB2CODE[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4};

  int64_t off = records_start;
  int64_t rec = 0;
  int64_t cig_off = 0;
  int64_t name_off = 0;

  while (off + 4 <= size)
  {
    int32_t block_size;
    memcpy(&block_size, data + off, 4);
    if (block_size <= 0 || off + 4 + block_size > size)
      break;
    uint8_t const * p = data + off + 4;

    int32_t rid, rpos, next_rid, next_pos, t_len, l_seq;
    memcpy(&rid, p, 4);
    memcpy(&rpos, p + 4, 4);
    uint8_t l_read_name = p[8];
    uint8_t mq = p[9];
    uint16_t n_cigar, fl;
    memcpy(&n_cigar, p + 12, 2);
    memcpy(&fl, p + 14, 2);
    memcpy(&l_seq, p + 16, 4);
    memcpy(&next_rid, p + 20, 4);
    memcpy(&next_pos, p + 24, 4);
    memcpy(&t_len, p + 28, 4);

    ref_id[rec] = rid;
    pos[rec] = rpos;
    flag[rec] = fl;
    mapq[rec] = mq;
    mate_ref_id[rec] = next_rid;
    mate_pos[rec] = next_pos;
    tlen[rec] = t_len;
    qlen[rec] = l_seq;

    uint8_t const * q = p + 32;
    // name
    memcpy(names + name_off, q, l_read_name);
    name_offsets[rec] = name_off;
    name_off += l_read_name;
    q += l_read_name;
    // cigar
    cigar_offsets[rec] = cig_off;
    for (uint16_t c = 0; c < n_cigar; ++c)
    {
      uint32_t oc;
      memcpy(&oc, q + 4 * c, 4);
      cigar_ops[cig_off] = static_cast<uint8_t>(oc & 15);
      cigar_lens[cig_off] = static_cast<int32_t>(oc >> 4);
      ++cig_off;
    }
    q += 4 * n_cigar;
    // seq nibbles
    uint8_t * seq_out = seqs + rec * seq_stride;
    for (int32_t s = 0; s < l_seq; ++s)
    {
      uint8_t nib = (s & 1) ? (q[s >> 1] & 0xF) : (q[s >> 1] >> 4);
      seq_out[s] = NIB2CODE[nib];
    }
    q += (l_seq + 1) / 2;
    // qual
    memcpy(quals + rec * seq_stride, q, l_seq);

    ++rec;
    off += 4 + block_size;
  }

  cigar_offsets[rec] = cig_off;
  name_offsets[rec] = name_off;
  return 0;
}

// ---------------------------------------------------------------------------
// K-mer packing: all overlapping 32-mers of a code sequence -> uint64 keys
// ---------------------------------------------------------------------------

int64_t gt_pack_kmers(uint8_t const * codes, int64_t n, uint64_t * kmers, uint8_t * valid)
{
  int const K = 32;
  if (n < K)
    return 0;
  int64_t out_n = n - K + 1;
  uint64_t key = 0;
  int bad = 0; // number of positions until the window is clean again

  for (int64_t i = 0; i < n; ++i)
  {
    uint8_t c = codes[i];
    key = (key << 2) | (c & 3);
    if (c >= 4)
      bad = K;
    else if (bad > 0)
      --bad;
    if (i >= K - 1)
    {
      int64_t o = i - (K - 1);
      kmers[o] = key; // mask not needed: uint64 holds exactly 32 bases
      valid[o] = bad == 0 ? 1 : 0;
    }
  }
  return out_n;
}

} // extern "C"

// ---------------------------------------------------------------------------
// rANS 4x8 decode (CRAM 3.0 codec, orders 0/1) — native twin of
// io/cram.py:_rans_decode_0/_rans_decode_1 (htslib rans_static.c semantics,
// verified against the reference's own test.cram). Returns 0 on success,
// -1 on malformed input (caller falls back to the Python decoder).
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t RANS_L = 1u << 23;
constexpr int TF_SHIFT = 12;
constexpr uint32_t TOTFREQ = 1u << TF_SHIFT;

struct RansReader {
  const uint8_t * d;
  int64_t n;
  int64_t p = 0;
  bool ok = true;

  uint8_t u8()
  {
    if (p >= n)
    {
      ok = false;
      return 0;
    }
    return d[p++];
  }

  uint8_t peek()
  {
    if (p >= n)
    {
      ok = false;
      return 0;
    }
    return d[p];
  }

  uint32_t freq()
  {
    uint32_t f = u8();
    if (f >= 128)
      f = ((f & 127) << 8) | u8();
    return f;
  }
};

// order-0 style symbol-RLE frequency table into freqs[256]
bool read_freqs0(RansReader & br, uint32_t * freqs)
{
  for (int s = 0; s < 256; ++s)
    freqs[s] = 0;
  int rle = 0;
  int j = br.u8();
  while (br.ok)
  {
    freqs[j & 255] = br.freq();
    if (rle > 0)
    {
      --rle;
      ++j;
    }
    else if (j + 1 < 256 && br.peek() == j + 1)
    {
      j = br.u8();
      rle = br.u8();
    }
    else
    {
      j = br.u8();
    }
    if (j == 0)
      break;
  }
  return br.ok;
}

} // namespace

extern "C" {

// Decode every consecutive ITF8 value in a CRAM external stream in one
// pass (io/cram.py ByteReader.itf8 semantics, signed 32-bit wrap).
// starts[i] is the byte offset where value i begins — the Python side uses
// it to keep value-index and byte-position views of the stream in sync
// (and to detect non-ITF8 regions by exact-offset mismatch). Outputs are
// sized >= len by the caller. Returns the value count.
int64_t gt_itf8_decode_all(const uint8_t * data, int64_t len, int64_t off, int32_t * values,
                           int64_t * starts)
{
  int64_t n = 0;
  while (off < len)
  {
    starts[n] = off;
    uint8_t b0 = data[off];
    uint32_t v;
    if (b0 < 0x80)
    {
      v = b0;
      off += 1;
    }
    else if (b0 < 0xC0)
    {
      if (off + 2 > len)
        break;
      v = ((uint32_t)(b0 & 0x7F) << 8) | data[off + 1];
      off += 2;
    }
    else if (b0 < 0xE0)
    {
      if (off + 3 > len)
        break;
      v = ((uint32_t)(b0 & 0x3F) << 16) | ((uint32_t)data[off + 1] << 8) | data[off + 2];
      off += 3;
    }
    else if (b0 < 0xF0)
    {
      if (off + 4 > len)
        break;
      v = ((uint32_t)(b0 & 0x1F) << 24) | ((uint32_t)data[off + 1] << 16)
        | ((uint32_t)data[off + 2] << 8) | data[off + 3];
      off += 4;
    }
    else
    {
      if (off + 5 > len)
        break;
      v = ((uint32_t)(b0 & 0x0F) << 28) | ((uint32_t)data[off + 1] << 20)
        | ((uint32_t)data[off + 2] << 12) | ((uint32_t)data[off + 3] << 4)
        | (data[off + 4] & 0x0F);
      off += 5;
    }
    values[n++] = (int32_t)v;
  }
  starts[n] = off; // sentinel: where parsing stopped (= value n's end)
  return n;
}

// Walk decompressed BAM records from `off` (end of the header/ref section):
// per record emit (uncompressed offset, tid, pos, reference end). Feeds the
// BAI builder (io/bai.py) — the boundary chain is inherently sequential, so
// the walk lives in C. Returns the record count (outputs sized >= len/36 by
// the caller), or -1 on a malformed record.
int64_t gt_bai_scan(const uint8_t * data, int64_t len, int64_t off, int64_t * rec_off,
                    int32_t * tid, int32_t * pos, int32_t * ref_end)
{
  int64_t n = 0;
  while (off + 4 <= len)
  {
    int32_t block_size;
    std::memcpy(&block_size, data + off, 4);
    int64_t end = off + 4 + block_size;
    if (block_size < 32 || end > len)
      return -1;
    int32_t t, p;
    std::memcpy(&t, data + off + 4, 4);
    std::memcpy(&p, data + off + 8, 4);
    uint8_t l_read_name = data[off + 12];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, data + off + 16, 2);
    int64_t span = 0;
    int64_t cig = off + 36 + l_read_name;
    if (cig + 4LL * n_cigar > end)
      return -1;
    for (int k = 0; k < n_cigar; ++k)
    {
      uint32_t c;
      std::memcpy(&c, data + cig + 4LL * k, 4);
      uint32_t op = c & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) // M D N = X
        span += c >> 4;
    }
    rec_off[n] = off;
    tid[n] = t;
    pos[n] = p;
    ref_end[n] = p + (int32_t)(span > 0 ? span : 1);
    ++n;
    off = end;
  }
  return n;
}

int64_t gt_rans_decode(const uint8_t * data, int64_t len, int32_t order, uint8_t * out,
                       int64_t out_size)
{
  RansReader br{data, len};
  if (out_size <= 0)
    return 0;

  if (order == 0)
  {
    uint32_t freqs[256];
    if (!read_freqs0(br, freqs))
      return -1;
    uint32_t cum[257];
    cum[0] = 0;
    for (int s = 0; s < 256; ++s)
      cum[s + 1] = cum[s] + freqs[s];
    if (cum[256] > TOTFREQ)
      return -1;
    std::vector<uint8_t> sym_of(TOTFREQ, 0);
    for (int s = 0; s < 256; ++s)
      for (uint32_t k = cum[s]; k < cum[s + 1]; ++k)
        sym_of[k] = (uint8_t)s;
    if (br.p + 16 > br.n)
      return -1;
    uint32_t st[4];
    std::memcpy(st, data + br.p, 16);
    int64_t p = br.p + 16;
    for (int64_t i = 0; i < out_size; ++i)
    {
      uint32_t & x = st[i & 3];
      uint32_t slot = x & (TOTFREQ - 1);
      uint8_t s = sym_of[slot];
      out[i] = s;
      x = freqs[s] * (x >> TF_SHIFT) + slot - cum[s];
      while (x < RANS_L && p < len)
        x = (x << 8) | data[p++];
    }
    return 0;
  }

  if (order == 1)
  {
    // per-context tables; contexts appear in symbol-RLE order like symbols
    std::vector<uint32_t> freqs(256 * 256, 0);
    std::vector<uint32_t> cum(256 * 257, 0);
    int rle_i = 0;
    int i = br.u8();
    while (br.ok)
    {
      // inner order-0 style table for context i
      {
        int rle_j = 0;
        int j = br.u8();
        while (br.ok)
        {
          freqs[(i & 255) * 256 + (j & 255)] = br.freq();
          if (rle_j > 0)
          {
            --rle_j;
            ++j;
          }
          else if (j + 1 < 256 && br.peek() == j + 1)
          {
            j = br.u8();
            rle_j = br.u8();
          }
          else
          {
            j = br.u8();
          }
          if (j == 0)
            break;
        }
      }
      if (rle_i > 0)
      {
        --rle_i;
        ++i;
      }
      else if (i + 1 < 256 && br.peek() == i + 1)
      {
        i = br.u8();
        rle_i = br.u8();
      }
      else
      {
        i = br.u8();
      }
      if (i == 0)
        break;
    }
    if (!br.ok)
      return -1;
    std::vector<uint8_t> lut(256 * TOTFREQ, 0);
    for (int c = 0; c < 256; ++c)
    {
      uint32_t * cc = &cum[c * 257];
      const uint32_t * fc = &freqs[c * 256];
      cc[0] = 0;
      for (int s = 0; s < 256; ++s)
        cc[s + 1] = cc[s] + fc[s];
      if (cc[256] > TOTFREQ)
        return -1;
      uint8_t * lc = &lut[(size_t)c * TOTFREQ];
      for (int s = 0; s < 256; ++s)
        for (uint32_t k = cc[s]; k < cc[s + 1]; ++k)
          lc[k] = (uint8_t)s;
    }
    if (br.p + 16 > br.n)
      return -1;
    uint32_t st[4];
    std::memcpy(st, data + br.p, 16);
    int64_t p = br.p + 16;
    int64_t q = out_size >> 2;
    int64_t idx[4] = {0, q, 2 * q, 3 * q};
    int64_t ends[4] = {q, 2 * q, 3 * q, out_size};
    uint32_t ctx[4] = {0, 0, 0, 0};
    for (int64_t k = 0; k < q; ++k)
    {
      for (int j = 0; j < 4; ++j)
      {
        uint32_t & x = st[j];
        uint32_t c = ctx[j];
        uint32_t slot = x & (TOTFREQ - 1);
        uint8_t s = lut[(size_t)c * TOTFREQ + slot];
        out[idx[j]++] = s;
        x = freqs[c * 256 + s] * (x >> TF_SHIFT) + slot - cum[c * 257 + s];
        while (x < RANS_L && p < len)
          x = (x << 8) | data[p++];
        ctx[j] = s;
      }
    }
    while (idx[3] < ends[3]) // remainder rides stream 3
    {
      uint32_t & x = st[3];
      uint32_t c = ctx[3];
      uint32_t slot = x & (TOTFREQ - 1);
      uint8_t s = lut[(size_t)c * TOTFREQ + slot];
      out[idx[3]++] = s;
      x = freqs[c * 256 + s] * (x >> TF_SHIFT) + slot - cum[c * 257 + s];
      while (x < RANS_L && p < len)
        x = (x << 8) | data[p++];
      ctx[3] = s;
    }
    return 0;
  }

  return -1;
}

} // extern "C"
