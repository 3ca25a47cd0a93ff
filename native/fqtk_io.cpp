// fqtk-tpu native host I/O engine.
//
// Native replacement for the reference's host-side crates (SURVEY.md §2b):
//   - seq_io FASTQ parsing            -> chunked memchr scanner over inflate
//   - fgoxide gzip readers            -> zlib multi-member inflate
//   - pooled-writer + bgzf            -> BGZF writer pool (worker threads,
//                                        per-writer in-order reorder buffer)
//   - ReadSet header rewriting        -> rewrite_header (byte-identical to
//                                        fqtk_tpu/core/headers.py, tested)
//
// The demux batch loop lives entirely in C++ (pipelined mode): persistent
// per-input parse threads free-run over a 4-slot window ring, the last
// thread to finish a window runs the skip/sync/pack gates inline, and a
// dedicated route thread rewrites headers and streams records to per-sample
// BGZF writers.  Python's only job per window is the device matcher call:
//   fqtk_demux_pipe_acquire(): block until a packed [B, L/2] barcode matrix
//                              is ready (zero-copy view of engine memory)
//   fqtk_demux_pipe_submit():  hand device assignments to the route thread
//
// Build: make -C native   (produces libfqtk_io.so; loaded via ctypes)

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cerrno>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

#if defined(__linux__)
#include <sched.h>
#include <sys/resource.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif

#if __has_include(<libdeflate.h>) && !defined(FQTK_NO_LIBDEFLATE)
#include <libdeflate.h>
#define FQTK_HAVE_LIBDEFLATE 1
#endif

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#define FQTK_X86_SIMD 1
#endif

#define FQTK_API extern "C" __attribute__((visibility("default")))

namespace {

inline uint64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Per-thread CPU time: stage costs stay honest when threads oversubscribe
// the host's cores (wall-clock would bill preemption to the preempted stage).
inline uint64_t thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

// Monotonic wall clock, for stall accounting (time a pipeline stage spends
// BLOCKED is invisible to thread-CPU counters by definition).
inline uint64_t wall_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

// ---------------------------------------------------------------------------
// error plumbing
// ---------------------------------------------------------------------------

struct ErrorState {
  // set() may be called from parse/route threads running concurrently;
  // msg is immutable once failed flips to true.
  std::mutex mu;
  std::string msg;
  std::atomic<bool> failed{false};
  void set(const std::string& m) {
    std::lock_guard<std::mutex> lk(mu);
    if (!failed.load()) {
      msg = m;
      failed.store(true);
    }
  }
};

// Python bytes-repr of a byte string (b'...'), matching CPython's rules:
// prefer single quotes, switch to double quotes iff the data contains a
// single quote and no double quote; escape backslash, the quote, \t \n \r,
// and non-printables as \xNN.  Used so native error text renders headers
// exactly like the Python engine's f-string of a bytes list.
std::string py_bytes_repr(const uint8_t* data, size_t len) {
  bool has_sq = memchr(data, '\'', len) != nullptr;
  bool has_dq = memchr(data, '"', len) != nullptr;
  char quote = (has_sq && !has_dq) ? '"' : '\'';
  std::string out = "b";
  out += quote;
  char buf[8];
  for (size_t i = 0; i < len; i++) {
    uint8_t c = data[i];
    if (c == static_cast<uint8_t>(quote) || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c == '\t') {
      out += "\\t";
    } else if (c == '\n') {
      out += "\\n";
    } else if (c == '\r') {
      out += "\\r";
    } else if (c < 0x20 || c >= 0x7f) {
      snprintf(buf, sizeof(buf), "\\x%02x", c);
      out += buf;
    } else {
      out += static_cast<char>(c);
    }
  }
  out += quote;
  return out;
}

std::string str_printf(const char* fmt, ...) {
  va_list args;
  va_start(args, fmt);
  char buf[4096];
  vsnprintf(buf, sizeof(buf), fmt, args);
  va_end(args);
  return std::string(buf);
}

// ---------------------------------------------------------------------------
// input stream: plain or (multi-member) gzip, 1 MiB buffered
// ---------------------------------------------------------------------------

class InputStream {
 public:
  explicit InputStream(const std::string& path) : path_(path) {
    file_ = fopen(path.c_str(), "rb");
    if (!file_) {
      ok_ = false;
      return;
    }
    unsigned char head[18];
    size_t n = fread(head, 1, sizeof(head), file_);
    // replay the sniffed bytes instead of seeking back, so non-seekable
    // inputs (pipes, process substitution) stream correctly — the
    // reference's buffered reader sniffs without consuming either
    memcpy(pushback_, head, n);
    pushback_len_ = n;
    gzipped_ = (n >= 2 && head[0] == 0x1f && head[1] == 0x8b);
#ifdef FQTK_HAVE_LIBDEFLATE
    // BGZF detection: FEXTRA with a 'BC' subfield.  BGZF members carry
    // their compressed size, so each 64KB block decompresses whole via
    // libdeflate (~2-3x faster than streaming zlib inflate) — and bgzip'd
    // FASTQs are the reference's own documented input workflow.
    if (gzipped_ && n == 18 && (head[3] & 4) && head[12] == 'B' &&
        head[13] == 'C' && head[14] == 2 && head[15] == 0) {
      bgzf_ = true;
      bgzf_decomp_ = libdeflate_alloc_decompressor();
      block_buf_.resize(1 << 16);
      comp_buf_.resize(1 << 16);
    }
#endif
    if (gzipped_ && !bgzf_) {
      memset(&strm_, 0, sizeof(strm_));
      // 15+32: zlib/gzip auto-detect; loop handles concatenated members
      inflate_live_ = inflateInit2(&strm_, 15 + 32) == Z_OK;
      if (!inflate_live_) ok_ = false;
      in_buf_.resize(1 << 20);
    }
  }

  ~InputStream() {
    // keyed on init success, NOT ok_ — a later read error (truncation,
    // corrupt stream) must still free the inflate window
    if (inflate_live_) inflateEnd(&strm_);
#ifdef FQTK_HAVE_LIBDEFLATE
    da_stop();
    if (bgzf_decomp_) libdeflate_free_decompressor(bgzf_decomp_);
#endif
    if (file_) fclose(file_);
  }

  bool ok() const { return ok_; }

  // Read up to `len` decompressed bytes; returns bytes read (0 == EOF).
  size_t read(uint8_t* dst, size_t len) {
    if (!ok_) return 0;
    if (!gzipped_) return raw_read(dst, len);
    if (bgzf_) return read_bgzf(dst, len);
    size_t total = 0;
    while (total < len) {
      if (strm_.avail_in == 0 && !raw_eof()) {
        size_t n = raw_read(in_buf_.data(), in_buf_.size());
        strm_.next_in = in_buf_.data();
        strm_.avail_in = static_cast<unsigned>(n);
      }
      if (strm_.avail_in == 0) {
        // true EOF — but EOF landing inside a deflate member means the
        // input is TRUNCATED (partial download, head -c): fail rather
        // than silently dropping the tail (the Python gzip reader and
        // the BGZF legs both fail on this; demux must never report
        // success over a partial input)
        if (mid_member_) ok_ = false;
        break;
      }
      strm_.next_out = dst + total;
      strm_.avail_out = static_cast<unsigned>(len - total);
      int ret = inflate(&strm_, Z_NO_FLUSH);
      total = len - strm_.avail_out;
      if (ret == Z_STREAM_END) {
        mid_member_ = false;
        members_++;
        // concatenated member boundary (BGZF files are many members)
        if (inflateReset2(&strm_, 15 + 32) != Z_OK) {
          ok_ = false;
          break;
        }
      } else if (ret == Z_OK) {
        mid_member_ = true;
      } else if (ret != Z_BUF_ERROR) {
        ok_ = false;
        break;
      }
      if (ret == Z_BUF_ERROR && strm_.avail_in == 0 && raw_eof()) {
        if (mid_member_) ok_ = false;
        break;
      }
    }
    return total;
  }

  const std::string& path() const { return path_; }

  // Enable block-parallel BGZF inflate with `n` worker threads (BGZF
  // members decode independently).  Call before the first read(); no-op
  // for n <= 1 or non-BGZF inputs.  Targets the case where fewer parse
  // threads than cores exist (e.g. single-input demux): one IO thread
  // streams compressed members, workers inflate them out of order, reads
  // consume in order.
  void set_decode_threads(int n) {
#ifdef FQTK_HAVE_LIBDEFLATE
    if (bgzf_ && ok_ && !da_ && n > 1) decode_threads_ = n;
#else
    (void)n;
#endif
  }

  bool is_gzipped() const { return gzipped_; }
  bool is_bgzf() const { return bgzf_; }
  // completed deflate members seen so far (streaming-zlib path only;
  // calibration use — distinguishes single-member gzip, whose inflate is
  // inherently serial, from concatenated-member files)
  uint64_t member_count() const { return members_; }

 private:
#ifdef FQTK_HAVE_LIBDEFLATE
  struct DecodeAhead {
    std::mutex mu;
    std::condition_variable cv_io, cv_work, cv_get;
    // seq -> raw member bytes (past the 18-byte header) awaiting inflate
    std::deque<std::pair<uint64_t, std::vector<uint8_t>>> comp_q;
    std::map<uint64_t, std::vector<uint8_t>> done;  // seq -> decompressed
    uint64_t produced = 0;   // members read from disk
    uint64_t consumed = 0;   // members handed to read()
    bool io_eof = false, failed = false, stopping = false;
    std::vector<std::thread> workers;
    std::thread io;
    static constexpr uint64_t kMaxInflight = 64;
  };

  void da_start() {
    da_ = std::make_unique<DecodeAhead>();
    da_->io = std::thread([this] { da_io_loop(); });
    for (int i = 0; i < decode_threads_; i++)
      da_->workers.emplace_back([this] { da_worker(); });
  }

  void da_stop() {
    if (!da_) return;
    {
      std::lock_guard<std::mutex> lk(da_->mu);
      da_->stopping = true;
      da_->cv_io.notify_all();
      da_->cv_work.notify_all();
      da_->cv_get.notify_all();
    }
    da_->io.join();
    for (auto& t : da_->workers) t.join();
  }

  void da_io_loop() {
    for (;;) {
      size_t payload_off = 0;
      const int64_t bsize = next_bgzf_header(&payload_off);
      bool bad = (bsize < 0), eof = (bsize == 0);
      std::vector<uint8_t> body;
      if (!eof && !bad) {
        body.resize(bsize - payload_off);
        if (raw_read(body.data(), body.size()) != body.size()) bad = true;
      }
      std::unique_lock<std::mutex> lk(da_->mu);
      if (bad) {
        da_->failed = true;
        da_->cv_get.notify_all();
        da_->cv_work.notify_all();
        return;
      }
      if (eof) {
        da_->io_eof = true;
        da_->cv_get.notify_all();
        da_->cv_work.notify_all();
        return;
      }
      da_->cv_io.wait(lk, [&] {
        return da_->stopping ||
               da_->produced - da_->consumed < DecodeAhead::kMaxInflight;
      });
      if (da_->stopping) return;
      da_->comp_q.emplace_back(da_->produced++, std::move(body));
      da_->cv_work.notify_one();
    }
  }

  void da_worker() {
    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    for (;;) {
      uint64_t seq;
      std::vector<uint8_t> body;
      {
        std::unique_lock<std::mutex> lk(da_->mu);
        da_->cv_work.wait(lk, [&] {
          return da_->stopping || da_->failed || !da_->comp_q.empty() ||
                 da_->io_eof;
        });
        if (da_->comp_q.empty()) {
          if (da_->stopping || da_->failed || da_->io_eof) break;
          continue;
        }
        seq = da_->comp_q.front().first;
        body = std::move(da_->comp_q.front().second);
        da_->comp_q.pop_front();
      }
      uint32_t isize;
      memcpy(&isize, body.data() + body.size() - 4, 4);
      std::vector<uint8_t> out;
      bool ok = isize <= (1 << 16);
      if (ok && isize > 0) {
        out.resize(isize);
        size_t out_n = 0;
        auto r = libdeflate_deflate_decompress(d, body.data(), body.size() - 8,
                                               out.data(), isize, &out_n);
        ok = (r == LIBDEFLATE_SUCCESS && out_n == isize);
      }
      std::lock_guard<std::mutex> lk(da_->mu);
      if (!ok) {
        da_->failed = true;
        da_->cv_get.notify_all();
        break;
      }
      da_->done.emplace(seq, std::move(out));
      da_->cv_get.notify_all();
    }
    libdeflate_free_decompressor(d);
  }

  // Pull the next in-order decompressed member into block_buf_.
  bool da_next_block() {
    std::unique_lock<std::mutex> lk(da_->mu);
    for (;;) {
      auto it = da_->done.find(da_->consumed);
      if (it != da_->done.end()) {
        block_buf_ = std::move(it->second);
        da_->done.erase(it);
        da_->consumed++;
        block_len_ = block_buf_.size();
        block_pos_ = 0;
        da_->cv_io.notify_one();
        if (block_len_ == 0) continue;  // EOF-marker member: next
        return true;
      }
      if (da_->failed) {
        ok_ = false;
        return false;
      }
      if (da_->io_eof && da_->consumed >= da_->produced) return false;
      da_->cv_get.wait(lk);
    }
  }

  // Whole-block BGZF decompression via libdeflate.
  size_t read_bgzf(uint8_t* dst, size_t len) {
    if (decode_threads_ > 1 && !da_) da_start();
    size_t total = 0;
    while (total < len) {
      if (block_pos_ == block_len_) {
        if (da_ ? !da_next_block() : !next_bgzf_block()) break;
      }
      size_t take = std::min(len - total, block_len_ - block_pos_);
      memcpy(dst + total, block_buf_.data() + block_pos_, take);
      block_pos_ += take;
      total += take;
    }
    return total;
  }

  // Reads one BGZF member's gzip header: fixed 12 bytes + the FEXTRA
  // field, scanning its subfields for 'BC' (the SAM spec requires BC to
  // be present, not to be the only subfield — htslib writes XLEN=6 but
  // other writers may add subfields).  Returns the total member size
  // (BSIZE+1) and sets *payload_off to where the deflate payload starts;
  // 0 == clean EOF, -1 == malformed/truncated.
  int64_t next_bgzf_header(size_t* payload_off) {
    uint8_t hdr[12];
    size_t n = raw_read(hdr, sizeof(hdr));
    if (n == 0) return 0;
    if (n != sizeof(hdr) || hdr[0] != 0x1f || hdr[1] != 0x8b ||
        hdr[2] != 8 || !(hdr[3] & 4))
      return -1;
    const size_t xlen = hdr[10] | (hdr[11] << 8);
    if (xlen < 6) return -1;
    uint8_t extra[1 << 16];
    if (raw_read(extra, xlen) != xlen) return -1;
    int64_t bsize = -1;
    for (size_t p = 0; p + 4 <= xlen;) {
      const size_t slen = extra[p + 2] | (extra[p + 3] << 8);
      if (extra[p] == 'B' && extra[p + 1] == 'C' && slen == 2 &&
          p + 6 <= xlen) {
        bsize = static_cast<int64_t>(extra[p + 4] | (extra[p + 5] << 8)) + 1;
        break;
      }
      p += 4 + slen;
    }
    *payload_off = 12 + xlen;
    if (bsize < static_cast<int64_t>(12 + xlen + 8) || bsize > (1 << 16))
      return -1;  // also covers "no BC subfield found" (bsize == -1)
    return bsize;
  }

  bool next_bgzf_block() {
    size_t payload_off = 0;
    const int64_t bsize = next_bgzf_header(&payload_off);
    if (bsize == 0) return false;  // EOF
    if (bsize < 0) {
      ok_ = false;  // mixed/truncated stream — refuse rather than misread
      return false;
    }
    size_t rest = bsize - payload_off;
    if (comp_buf_.size() < rest) comp_buf_.resize(rest);
    if (raw_read(comp_buf_.data(), rest) != rest) {
      ok_ = false;
      return false;
    }
    uint32_t isize;
    memcpy(&isize, comp_buf_.data() + rest - 4, 4);
    if (isize > (1 << 16)) {
      ok_ = false;
      return false;
    }
    size_t out_n = 0;
    if (isize > 0) {
      auto r = libdeflate_deflate_decompress(
          bgzf_decomp_, comp_buf_.data(), rest - 8, block_buf_.data(), isize,
          &out_n);
      if (r != LIBDEFLATE_SUCCESS || out_n != isize) {
        ok_ = false;
        return false;
      }
    }
    block_len_ = isize;
    block_pos_ = 0;
    // zero-length blocks (EOF marker) just loop to the next member
    return isize > 0 ? true : next_bgzf_block();
  }
#else
  size_t read_bgzf(uint8_t*, size_t) { return 0; }
#endif

  // Compressed/raw byte source: the constructor's sniffed header bytes
  // replay first (never seek — pipes can't), then the file continues.
  // Kept out of line: inlined into a caller with a stack InputStream, GCC
  // 13's -Warray-bounds mistakes `dst` for a pointer into that object.
  __attribute__((noinline)) size_t raw_read(uint8_t* dst, size_t len) {
    size_t total = 0;
    if (pushback_pos_ < pushback_len_) {
      size_t take = std::min(len, pushback_len_ - pushback_pos_);
      memcpy(dst, pushback_ + pushback_pos_, take);
      pushback_pos_ += take;
      total = take;
    }
    if (total < len) total += fread(dst + total, 1, len - total, file_);
    return total;
  }

  bool raw_eof() const {
    return pushback_pos_ >= pushback_len_ && feof(file_);
  }

  std::string path_;
  FILE* file_ = nullptr;
  uint8_t pushback_[18];
  size_t pushback_len_ = 0, pushback_pos_ = 0;
  bool gzipped_ = false;
  bool bgzf_ = false;
  bool ok_ = true;
  bool inflate_live_ = false;   // inflateInit2 succeeded (owns a window)
  bool mid_member_ = false;     // EOF here == truncated member
  uint64_t members_ = 0;        // completed members (streaming path)
  z_stream strm_;
  std::vector<uint8_t> in_buf_;
#ifdef FQTK_HAVE_LIBDEFLATE
  libdeflate_decompressor* bgzf_decomp_ = nullptr;
  int decode_threads_ = 1;
  std::unique_ptr<DecodeAhead> da_;
#endif
  std::vector<uint8_t> block_buf_, comp_buf_;
  size_t block_pos_ = 0, block_len_ = 0;
};

// ---------------------------------------------------------------------------
// FASTQ record scanner (strict 4-line records, CR-tolerant)
// ---------------------------------------------------------------------------

struct RecordView {
  // offsets into the parser's line buffer; valid until next fill
  const uint8_t* head;  // without '@'
  size_t head_len;
  const uint8_t* seq;
  size_t seq_len;
  const uint8_t* plus;  // separator line, verbatim (may carry a comment)
  size_t plus_len;
  const uint8_t* qual;
  size_t qual_len;
};

class FastqScanner {
 public:
  FastqScanner(std::unique_ptr<InputStream> in) : in_(std::move(in)) {
    buf_.resize(1 << 20);
  }

  bool ok() const { return in_->ok() && !error_; }
  const std::string& error_msg() const { return error_msg_; }
  const std::string& path() const { return in_->path(); }
  InputStream* stream() { return in_.get(); }

  // Returns: 1 = record, 0 = EOF, -1 = error.  The returned views point into
  // the scanner's buffer and stay valid until the next call to next().
  int next(RecordView* out) {
    record_start_ = pos_;  // compaction keeps data from here on
    size_t offs[4], lens[4];
    for (int i = 0; i < 4; i++) {
      size_t shift = 0;
      int r = next_line(&offs[i], &lens[i], &shift);
      if (shift) {
        // compaction moved the record's bytes; earlier offsets shift too
        for (int j = 0; j < i; j++) offs[j] -= shift;
      }
      if (r == 0) {
        if (i == 0) return 0;
        error_ = true;
        error_msg_ =
            str_printf("%s: truncated FASTQ record", in_->path().c_str());
        return -1;
      }
      if (r < 0) return -1;
    }
    const uint8_t* base = buf_.data();
    if (lens[0] < 1 || base[offs[0]] != '@') {
      error_ = true;
      error_msg_ = str_printf(
          "%s: FASTQ record header must start with '@'", in_->path().c_str());
      return -1;
    }
    if (lens[2] < 1 || base[offs[2]] != '+') {
      error_ = true;
      error_msg_ = str_printf(
          "%s: FASTQ separator line must start with '+'", in_->path().c_str());
      return -1;
    }
    if (lens[1] != lens[3]) {
      error_ = true;
      error_msg_ = str_printf(
          "%s: sequence and quality lengths differ (%zu vs %zu)",
          in_->path().c_str(), lens[1], lens[3]);
      return -1;
    }
    out->head = base + offs[0] + 1;
    out->head_len = lens[0] - 1;
    out->seq = base + offs[1];
    out->seq_len = lens[1];
    out->plus = base + offs[2];
    out->plus_len = lens[2];
    out->qual = base + offs[3];
    out->qual_len = lens[3];
    return 1;
  }

 private:
  // Fetch the next line (without newline / trailing CR) as an offset into
  // buf_.  If the buffer was compacted during the call, *shift_out reports
  // how far previously returned offsets moved down.
  int next_line(size_t* off_out, size_t* len_out, size_t* shift_out) {
    for (;;) {
      uint8_t* nl = static_cast<uint8_t*>(
          memchr(buf_.data() + pos_, '\n', end_ - pos_));
      if (nl) {
        size_t start = pos_;
        size_t l = nl - (buf_.data() + pos_);
        *off_out = start;
        *len_out = (l > 0 && buf_[start + l - 1] == '\r') ? l - 1 : l;
        pos_ = (nl - buf_.data()) + 1;
        return 1;
      }
      size_t remaining = end_ - pos_;
      if (record_start_ > 0) {
        // keep bytes from the current record's start
        size_t keep = end_ - record_start_;
        memmove(buf_.data(), buf_.data() + record_start_, keep);
        *shift_out += record_start_;
        pos_ -= record_start_;
        end_ = keep;
        record_start_ = 0;
      } else if (end_ == buf_.size()) {
        buf_.resize(buf_.size() * 2);  // record longer than buffer
      }
      size_t n = in_->read(buf_.data() + end_, buf_.size() - end_);
      if (!in_->ok()) {
        error_ = true;
        error_msg_ =
            str_printf("%s: read/decompress error", in_->path().c_str());
        return -1;
      }
      if (n == 0) {
        if (remaining == 0) return 0;
        // final line without newline
        *off_out = pos_;
        size_t l = remaining;
        *len_out = (l > 0 && buf_[pos_ + l - 1] == '\r') ? l - 1 : l;
        pos_ = end_;
        return 1;
      }
      end_ += n;
    }
  }

  std::unique_ptr<InputStream> in_;
  std::vector<uint8_t> buf_;
  size_t pos_ = 0, end_ = 0, record_start_ = 0;
  bool error_ = false;
  std::string error_msg_;
};

// ---------------------------------------------------------------------------
// BGZF writer pool
// ---------------------------------------------------------------------------

constexpr size_t kBgzfBlockInput = 0xff00;
const uint8_t kBgzfEof[28] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                              0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00,
                              0x03, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
                              0x00, 0x00};

struct CompressJob {
  class BgzfWriter* writer;
  uint64_t seq;
  std::vector<uint8_t> data;
};

class CompressorPool;

class BgzfWriter {
 public:
  BgzfWriter(const std::string& path, int level, CompressorPool* pool,
             ErrorState* err = nullptr)
      : path_(path), level_(level), pool_(pool), err_(err) {
    file_ = fopen(path.c_str(), "wb");
    ok_ = file_ != nullptr;
    buf_.reserve(kBgzfBlockInput);
  }

  bool ok() const { return ok_; }

  void write(const uint8_t* data, size_t len);

  // In-place formatting: returns a pointer with at least max_len bytes of
  // contiguous buffer space (submitting the current block first if needed;
  // partial blocks are valid BGZF).  Caller writes <= max_len bytes and
  // calls commit(actual).  max_len must be < kBgzfBlockInput.
  //
  // The block buffer is sized to full capacity once per block and filled
  // through the separate `len_` cursor: per-record vector::resize would
  // zero-fill every reservation (~276 cycles/record measured on the route
  // hot path — comparable to the whole header rewrite).
  uint8_t* reserve(size_t max_len) {
    if (len_ + max_len > kBgzfBlockInput) submit_block();
    if (buf_.size() != kBgzfBlockInput) buf_.resize(kBgzfBlockInput);
    reserve_off_ = len_;
    return buf_.data() + reserve_off_;
  }
  void commit(size_t actual) { len_ = reserve_off_ + actual; }

  // Submit the final partial block to the pool WITHOUT waiting.  Calling
  // this for every writer before the close() loop turns the end-of-run
  // drain from ~n_writers serial pool round-trips (each close submits its
  // own last block and then blocks on it) into one parallel flush wave.
  void flush_final() {
    if (!closed_ && file_ && len_ > 0) submit_block();
  }

  // Returns false if any delivery, the EOF block, or the final flush
  // failed to reach disk (ENOSPC, EIO, ...).  The error is also recorded
  // in the engine's ErrorState when one was provided — a demux/subsample
  // run must FAIL on a short write, never report success over truncated
  // outputs (the reference's io::Result plumbing gives it the same
  // guarantee).
  bool close();
  ~BgzfWriter() { close(); }

  // called by pool threads
  void deliver(uint64_t seq, std::vector<uint8_t> compressed);

  int level() const { return level_; }

 private:
  void submit_block();

  void write_error() {
    // errno is only meaningful right after the failing stdio call
    std::string msg = str_printf("Error writing output file %s: %s",
                                 path_.c_str(), strerror(errno));
    write_failed_.store(true);
    if (err_) err_->set(msg);
  }

  std::string path_;
  FILE* file_ = nullptr;
  bool ok_ = true;
  bool closed_ = false;
  std::atomic<bool> write_failed_{false};
  int level_;
  CompressorPool* pool_;
  ErrorState* err_ = nullptr;
  std::vector<uint8_t> buf_;  // capacity-sized per block; len_ is the cursor
  size_t len_ = 0;
  size_t reserve_off_ = 0;
  uint64_t next_submit_ = 0;

  std::mutex mu_;  // guards out-of-order delivery
  uint64_t next_write_ = 0;
  std::map<uint64_t, std::vector<uint8_t>> pending_;
  std::condition_variable drained_;
};

class CompressorPool {
 public:
  explicit CompressorPool(int threads, size_t max_queue)
      : max_queue_(max_queue) {
    for (int i = 0; i < std::max(1, threads); i++) {
      workers_.emplace_back([this] { worker(); });
    }
  }

  ~CompressorPool() { stop(); }

  void submit(CompressJob job) {
    std::unique_lock<std::mutex> lk(mu_);
    // Producer backpressure doubles as work-stealing: a full queue means
    // the compressors are the binding resource, so the producer (the route
    // thread / its helpers) runs the oldest job itself instead of parking —
    // its stall becomes compression throughput.  Out-of-order completion is
    // fine (BgzfWriter::deliver reorders by seq).  donate_on_full is OFF for
    // the refproxy baseline, whose pooled-writer model blocks producers.
    if (donate_on_full.load(std::memory_order_relaxed)) {
      while (queue_.size() >= max_queue_ && !stopping_) {
        CompressJob steal = std::move(queue_.front());
        queue_.pop_front();
        not_full_.notify_one();
        lk.unlock();
        uint64_t dt = run_job(steal);
        donated_ns += dt;
        tl_donated() += dt;
        lk.lock();
      }
    } else {
      not_full_.wait(lk,
                     [&] { return queue_.size() < max_queue_ || stopping_; });
    }
    queue_.push_back(std::move(job));
    not_empty_.notify_one();
  }

  // Pop and run at most one queued job on the calling thread; returns false
  // immediately when the queue is empty.  Used by pipeline threads that are
  // stalled waiting on another stage: their idle wall time drains compress
  // backlog instead (the donated CPU is charged to compress via run_job and
  // excluded from the caller's own stage bucket via tl_donated()).
  bool try_assist_one() {
    CompressJob job;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (queue_.empty()) return false;
      job = std::move(queue_.front());
      queue_.pop_front();
      not_full_.notify_one();
    }
    uint64_t dt = run_job(job);
    donated_ns += dt;
    tl_donated() += dt;
    return true;
  }

  // CPU-ns of pool jobs run on the CALLING thread (steals/assists); lets a
  // pipeline stage subtract donated compression from its own accounting
  // (run_job already counted it in busy_ns).
  static uint64_t& tl_donated() {
    static thread_local uint64_t v = 0;
    return v;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stopping_) return;
      stopping_ = true;
    }
    not_empty_.notify_all();
    not_full_.notify_all();
    for (auto& t : workers_) t.join();
    workers_.clear();
  }

  // Run the worker loop on the CALLING thread until `quit` is set (or the
  // pool stops) and the queue is empty.  Lets pipeline threads whose own
  // stage has finished (parse threads at EOF) help drain the compress
  // queue instead of idling — the end-of-run drain otherwise runs on
  // n_compressor threads while the rest of the host sits parked
  // (measured ~0.8-1.0 core-s of idle per run).
  void assist(const std::atomic<bool>& quit) {
    for (;;) {
      CompressJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        not_empty_.wait(lk, [&] {
          return !queue_.empty() || stopping_ || quit.load();
        });
        if (queue_.empty()) {
          if (stopping_ || quit.load()) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
        not_full_.notify_one();
      }
      uint64_t dt = run_job(job);
      donated_ns += dt;
      tl_donated() += dt;
    }
  }

  // Wake threads parked in assist() after their quit flag is raised.  The
  // quit store happens outside mu_, so take the lock (empty critical
  // section) before notifying: a waiter that read quit==false under mu_
  // has either blocked by the time we acquire it (the notify reaches it)
  // or will re-evaluate after our release and see the store — without the
  // lock, a notify landing between its predicate check and its block is
  // lost and the thread parks forever.
  void wake_assist() {
    { std::lock_guard<std::mutex> lk(mu_); }
    not_empty_.notify_all();
  }

  static std::vector<uint8_t> compress_block(const std::vector<uint8_t>& in,
                                             int level) {
    // raw deflate with headroom; BGZF framing around it.  libdeflate when
    // available (2-3x faster than zlib -- the reference's bgzf crate uses it
    // too, which is also why its --compression-level range is 1..=12);
    // zlib fallback otherwise.
    size_t body;
    std::vector<uint8_t> out;
#ifdef FQTK_HAVE_LIBDEFLATE
    {
      thread_local struct Compressor {
        libdeflate_compressor* c = nullptr;
        int level = -1;
        // freed at worker-thread exit: pools are created per engine run,
        // so a leak here would grow RSS with every open/close cycle
        ~Compressor() {
          if (c) libdeflate_free_compressor(c);
        }
      } tl;
      if (tl.level != level) {
        if (tl.c) libdeflate_free_compressor(tl.c);
        tl.c = libdeflate_alloc_compressor(level);
        tl.level = level;
      }
      size_t bound = libdeflate_deflate_compress_bound(tl.c, in.size());
      out.resize(18 + bound + 8);
      body = libdeflate_deflate_compress(tl.c, in.data(), in.size(),
                                         out.data() + 18, bound);
      if (body == 0) {
        // incompressible beyond bound (shouldn't happen with compress_bound)
        out.clear();
      }
    }
    if (out.empty())
#endif
    {
      z_stream s;
      memset(&s, 0, sizeof(s));
      deflateInit2(&s, std::min(level, 9), Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY);
      out.assign(18 + deflateBound(&s, in.size()) + 8, 0);
      s.next_in = const_cast<uint8_t*>(in.data());
      s.avail_in = static_cast<unsigned>(in.size());
      s.next_out = out.data() + 18;
      s.avail_out = static_cast<unsigned>(out.size() - 26);
      deflate(&s, Z_FINISH);
      body = out.size() - 26 - s.avail_out;
      deflateEnd(&s);
    }
    size_t total = 18 + body + 8;
    uint16_t bsize = static_cast<uint16_t>(total - 1);
    uint8_t* h = out.data();
    h[0] = 0x1f; h[1] = 0x8b; h[2] = 8; h[3] = 4;
    memset(h + 4, 0, 4);          // mtime
    h[8] = 0; h[9] = 0xff;        // xfl, os
    h[10] = 6; h[11] = 0;         // xlen
    h[12] = 'B'; h[13] = 'C'; h[14] = 2; h[15] = 0;
    h[16] = bsize & 0xff; h[17] = bsize >> 8;
#ifdef FQTK_HAVE_LIBDEFLATE
    uint32_t crc = libdeflate_crc32(0, in.data(), in.size());
#else
    uint32_t crc = crc32(0, in.data(), in.size());
#endif
    uint32_t isize = static_cast<uint32_t>(in.size());
    uint8_t* t = out.data() + 18 + body;
    memcpy(t, &crc, 4);
    memcpy(t + 4, &isize, 4);
    out.resize(total);
    return out;
  }

 private:
  void worker() {
#if defined(__linux__)
    // Pool workers intentionally oversubscribe the cores (pool size >
    // cores on small hosts) so compression can soak every idle cycle —
    // but a compressor must never PREEMPT a parse/scan thread, whose
    // stretch propagates through the window/chunk barriers into pipeline
    // stall.  nice +5 keeps compressors strictly below the default-
    // priority pipeline threads while still using all leftover CPU.
    // (Per-thread setpriority is Linux-specific; elsewhere this is a
    // no-op and the scheduler's fairness decides.)
    if (getenv("FQTK_POOL_NO_NICE") == nullptr) {
      setpriority(PRIO_PROCESS, static_cast<id_t>(syscall(SYS_gettid)), 5);
    }
#endif
    for (;;) {
      CompressJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        not_empty_.wait(lk, [&] { return !queue_.empty() || stopping_; });
        if (queue_.empty()) {
          if (stopping_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
        not_full_.notify_one();
      }
      run_job(job);
    }
  }

  uint64_t run_job(CompressJob& job) {
    uint64_t t0 = thread_cpu_ns();
    size_t in_bytes = job.data.size();
    auto compressed = compress_block(job.data, job.writer->level());
    size_t out_bytes = compressed.size();
    // deliver (the in-order fwrite of the compressed block) is counted as
    // compress-stage work: emitting output bytes is irreducible pipeline
    // cost any implementation pays, and it runs on this worker's clock
    job.writer->deliver(job.seq, std::move(compressed));
    uint64_t dt = thread_cpu_ns() - t0;
    busy_ns += dt;
    bytes_in += in_bytes;
    bytes_out += out_bytes;
    return dt;
  }

 public:
  // cumulative worker-thread stats (summed across threads); donated_ns is
  // the subset of busy_ns run on non-pool threads (steals/assists)
  std::atomic<uint64_t> busy_ns{0}, bytes_in{0}, bytes_out{0};
  std::atomic<uint64_t> donated_ns{0};
  //: refproxy baseline runs clear this: the reference's pooled-writer
  //: blocks producers on a full queue rather than having them compress
  std::atomic<bool> donate_on_full{true};

 private:
  size_t max_queue_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<CompressJob> queue_;
  bool stopping_ = false;
  std::vector<std::thread> workers_;
};

void BgzfWriter::write(const uint8_t* data, size_t len) {
  while (len > 0) {
    if (buf_.size() != kBgzfBlockInput) buf_.resize(kBgzfBlockInput);
    size_t take = std::min(len, kBgzfBlockInput - len_);
    memcpy(buf_.data() + len_, data, take);
    len_ += take;
    data += take;
    len -= take;
    if (len_ == kBgzfBlockInput) submit_block();
  }
}

void BgzfWriter::submit_block() {
  buf_.resize(len_);  // shrink to the filled prefix: no re-initialization
  CompressJob job;
  job.writer = this;
  job.seq = next_submit_++;
  job.data = std::move(buf_);
  buf_.clear();
  len_ = 0;
  pool_->submit(std::move(job));
}

void BgzfWriter::deliver(uint64_t seq, std::vector<uint8_t> compressed) {
  std::unique_lock<std::mutex> lk(mu_);
  pending_[seq] = std::move(compressed);
  while (!pending_.empty() && pending_.begin()->first == next_write_) {
    auto it = pending_.begin();
    // after the first short write, keep draining the sequence (so close()
    // can complete) but stop touching the file
    if (!write_failed_.load() &&
        fwrite(it->second.data(), 1, it->second.size(), file_) !=
            it->second.size()) {
      write_error();
    }
    pending_.erase(it);
    next_write_++;
  }
  if (pending_.empty()) drained_.notify_all();
}

bool BgzfWriter::close() {
  if (closed_ || !file_) return !write_failed_.load();
  closed_ = true;
  if (len_ > 0) submit_block();
  {
    std::unique_lock<std::mutex> lk(mu_);
    drained_.wait(lk, [&] { return next_write_ == next_submit_; });
  }
  if (!write_failed_.load() &&
      fwrite(kBgzfEof, 1, sizeof(kBgzfEof), file_) != sizeof(kBgzfEof)) {
    write_error();
  }
  // fclose flushes the stdio buffer — a deferred ENOSPC surfaces here
  if (fclose(file_) != 0 && !write_failed_.load()) write_error();
  file_ = nullptr;
  return !write_failed_.load();
}

// ---------------------------------------------------------------------------
// header rewriting (byte-identical to fqtk_tpu/core/headers.py)
// ---------------------------------------------------------------------------

// Formats a non-negative int as decimal without snprintf's locale/format
// machinery (the route hot path renders two ints per output record; glibc
// snprintf measured ~400 cycles vs ~10 for this).
inline int format_int(char* dst, int v) {
  char tmp[12];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v > 0);
  for (int i = 0; i < n; i++) dst[i] = tmp[n - 1 - i];
  return n;
}

inline int64_t rewrite_header_buf(
    uint8_t* out, const uint8_t* header, size_t header_len, int read_num,
    const std::vector<std::pair<const uint8_t*, size_t>>& bc,
    const std::vector<std::pair<const uint8_t*, size_t>>& umi,
    std::string* err);

// Appends the rewritten header (including '@') to `out`. Returns false and
// sets err on contract violations.  Thin wrapper over rewrite_header_buf —
// the header-contract logic must live in exactly one place (this is the
// cold >64KB-record path; the hot route path calls the cursor variant
// directly).
bool rewrite_header(std::vector<uint8_t>& out, const uint8_t* header,
                    size_t header_len, int read_num,
                    const std::vector<std::pair<const uint8_t*, size_t>>& bc,
                    const std::vector<std::pair<const uint8_t*, size_t>>& umi,
                    std::string* err) {
  // upper bound: '@' + name + sep + UMIs(+separators) + ' ' + synthesized
  // or rewritten comment (adds at most ~8 bytes over the original) +
  // barcodes(+separators)
  size_t extra = 40;
  for (const auto& u : umi) extra += u.second + 1;
  for (const auto& b : bc) extra += b.second + 1;
  const size_t base = out.size();
  out.resize(base + header_len + extra);
  const int64_t n = rewrite_header_buf(out.data() + base, header, header_len,
                                       read_num, bc, umi, err);
  if (n < 0) {
    out.resize(base);
    return false;
  }
  out.resize(base + static_cast<size_t>(n));
  return true;
}

// Cursor-based variant of rewrite_header: writes into `out` (caller
// guarantees capacity), returns bytes written or -1 with *err set.
inline int64_t rewrite_header_buf(
    uint8_t* out, const uint8_t* header, size_t header_len, int read_num,
    const std::vector<std::pair<const uint8_t*, size_t>>& bc,
    const std::vector<std::pair<const uint8_t*, size_t>>& umi,
    std::string* err) {
  const uint8_t* space =
      static_cast<const uint8_t*>(memchr(header, ' ', header_len));
  const uint8_t* name = header;
  size_t name_len = space ? (space - header) : header_len;
  const uint8_t* comment = space ? space + 1 : nullptr;
  size_t comment_len = space ? header_len - name_len - 1 : 0;

  uint8_t* p = out;
  *p++ = '@';

  if (!umi.empty()) {
    int sep_count = 0;
    for (size_t i = 0; i < name_len; i++)
      if (name[i] == ':') sep_count++;
    if (sep_count > 7) {
      *err = "Can't handle read name with more than 8 segments: " +
             std::string(reinterpret_cast<const char*>(header), header_len);
      return -1;
    }
    memcpy(p, name, name_len);
    p += name_len;
    *p++ = sep_count == 7 ? '+' : ':';
    for (size_t i = 0; i < umi.size(); i++) {
      if (i > 0) *p++ = '+';
      memcpy(p, umi[i].first, umi[i].second);
      p += umi[i].second;
    }
  } else {
    memcpy(p, name, name_len);
    p += name_len;
  }

  *p++ = ' ';

  if (!comment) {
    p += format_int(reinterpret_cast<char*>(p), read_num);
    memcpy(p, ":N:0:", 5);
    p += 5;
  } else {
    int sep_count = 0;
    for (size_t i = 0; i < comment_len; i++)
      if (comment[i] == ':') sep_count++;
    if (sep_count < 3) {
      if (comment_len == 0) {
        // header ends in a space: the reference fail-fasts here
        // (chars.last().unwrap() on None, demux.rs:231)
        *err = "Header comment is empty: " +
               std::string(reinterpret_cast<const char*>(header), header_len);
        return -1;
      }
      memcpy(p, comment, comment_len);
      p += comment_len;
      if (comment[comment_len - 1] != ':') *p++ = ':';
    } else {
      if (sep_count != 3) {
        *err = "Comment in did not have 4 segments: " +
               std::string(reinterpret_cast<const char*>(header), header_len);
        return -1;
      }
      const uint8_t* fc =
          static_cast<const uint8_t*>(memchr(comment, ':', comment_len));
      size_t first_colon = fc - comment;
      const uint8_t* rem = comment + first_colon + 1;
      size_t rem_len = comment_len - first_colon - 1;
      if (rem_len > 0 && comment[comment_len - 1] >= '0' &&
          comment[comment_len - 1] <= '9')
        rem_len -= 1;
      if (rem_len == 0) {
        // unreachable for a 4-part comment, but the reference's
        // remainder.last().unwrap() (demux.rs:251) would panic here
        *err = "Header comment index section is empty: " +
               std::string(reinterpret_cast<const char*>(header), header_len);
        return -1;
      }
      p += format_int(reinterpret_cast<char*>(p), read_num);
      *p++ = ':';
      memcpy(p, rem, rem_len);
      p += rem_len;
      if (rem[rem_len - 1] != ':') *p++ = '+';
    }
  }

  for (size_t i = 0; i < bc.size(); i++) {
    if (i > 0) *p++ = '+';
    memcpy(p, bc[i].first, bc[i].second);
    p += bc[i].second;
  }
  return p - out;
}

// ---------------------------------------------------------------------------
// IUPAC tables (mirrors fqtk_tpu/core/encoding.py)
// ---------------------------------------------------------------------------

struct IupacTables {
  uint8_t encode[256];   // byte -> 4-bit mask (nocall -> 15)
  uint8_t nocall[256];   // byte -> 1 if N/n/.
  char decode[16];       // mask -> IUPAC letter ('\0' if invalid)
  IupacTables() {
    memset(encode, 0, sizeof(encode));
    memset(nocall, 0, sizeof(nocall));
    memset(decode, 0, sizeof(decode));
    auto set = [&](char c, uint8_t m) {
      encode[static_cast<uint8_t>(c)] = m;
      encode[static_cast<uint8_t>(c) + 32] = m;  // lowercase
    };
    set('A', 1); set('C', 2); set('G', 4); set('T', 8); set('U', 8);
    set('M', 3); set('R', 5); set('W', 9); set('S', 6); set('Y', 10);
    set('K', 12); set('V', 7); set('H', 11); set('D', 13); set('B', 14);
    set('N', 15);
    nocall['N'] = nocall['n'] = nocall['.'] = 1;
    encode['.'] = 15;
    const char* letters = "ACGTMRWSYKVHDBN";
    for (const char* p = letters; *p; p++)
      decode[encode[static_cast<uint8_t>(*p)]] = *p;
  }
};
const IupacTables kIupac;

// byte -> 2-bit ACGT code via the IUPAC mask (U == T); -1 for any
// ambiguous/no-call byte (mask not a single bit)
inline int base_code2(uint8_t b) {
  switch (kIupac.encode[b]) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// demux engine
// ---------------------------------------------------------------------------

struct SegmentDef {
  int32_t offset;
  int32_t length;  // -1 = variable
  char kind;       // T/B/M/C/S
};

struct InputDef {
  std::string path;
  std::string structure_str;
  std::vector<SegmentDef> segments;
  int32_t min_len;
};

// Parsed record within a per-input batch arena.
struct RecEntry {
  uint32_t head_off;
  uint32_t head_len;
  uint32_t seq_off;
  uint32_t seq_len;
  uint32_t qual_off;
  // qual_len == seq_len (validated by the scanner)
};

// One input's share of a batch, filled by its parse thread.
struct InputBatch {
  std::vector<uint8_t> arena;
  std::vector<RecEntry> recs;
  bool failed = false;
  std::string error;

  void reset() {
    arena.clear();
    recs.clear();
    failed = false;
    error.clear();
  }
};

// Double-buffered batch slot: per-input record arrays + per-template flags.
struct BatchSlot {
  std::vector<InputBatch> per_input;
  int64_t n_templates = 0;
};

class DemuxEngine {
 public:
  ErrorState err;

  bool init(int n_threads, int compression_level) {
    pool_ = std::make_unique<CompressorPool>(n_threads,
                                             std::max(8, n_threads * 50));
    level_ = compression_level;
    route_threads_ = std::max(1, std::min(4, n_threads / 2));
    // Stall-assist: stalled pipeline threads and
    // queue-full producers run compress jobs instead of parking.  Default
    // OFF: interleaved A/B on the 4-core bench host measured it a wash-to-
    // loss (dual-index median 1.33M vs 1.45M off) — the pool already has
    // >= n_threads workers, so idle cores mean an EMPTY compress queue,
    // not missing compressors, and stealing only adds oversubscription.
    // FQTK_STALL_ASSIST=1 opts in for hosts where compressor threads are
    // genuinely scarce relative to cores.
    if (const char* env = getenv("FQTK_STALL_ASSIST"))
      stall_assist_ = env[0] == '1';
    pool_->donate_on_full.store(stall_assist_);
    return true;
  }

  // Per-input zero-copy parse state: the slot arena doubles as the inflate
  // target, records are scanned in place (offsets stay stable because the
  // arena only grows within a window), and the partial tail carries over.
  struct ParseState {
    std::unique_ptr<InputStream> in;
    std::vector<uint8_t> carry;
    bool eof = false;
  };

  bool add_input(const char* path, const char* structure_str,
                 const SegmentDef* segs, int n_segs) {
    InputDef def;
    def.path = path;
    def.structure_str = structure_str;
    def.min_len = 0;
    for (int i = 0; i < n_segs; i++) {
      def.segments.push_back(segs[i]);
      def.min_len += segs[i].length < 0 ? 1 : segs[i].length;
    }
    auto in = std::make_unique<InputStream>(path);
    if (!in->ok()) {
      err.set(str_printf("Error opening input file for reading: %s", path));
      return false;
    }
    auto st = std::make_unique<ParseState>();
    st->in = std::move(in);
    parse_states_.push_back(std::move(st));
    inputs_.push_back(std::move(def));
    return true;
  }

  bool add_sample_writer(const char* path) {
    // Opens are deferred to open_writers(): creating a production run's
    // worth of writers (96 samples x 2 segments x {sample, unmatched} ~ 200
    // fopens) serially here cost ~50ms of 4-core idle at startup; the
    // opener now overlaps the pipeline fill (pipe_start) or runs multi-
    // threaded (refproxy).  Directory writability is still validated up
    // front by the driver, so the rare per-file failure surfaces with the
    // same message, just at first poll instead of at add time.
    current_paths_.push_back(path);
    return true;
  }

  void end_sample() {
    writer_paths_.push_back(std::move(current_paths_));
    current_paths_.clear();
  }

  // Build every sample's BgzfWriter set from the recorded paths, fanning
  // the fopens over up to 4 threads.  Idempotent; returns false with err
  // set if any open failed.
  bool open_writers() {
    if (writers_opened_) return !err.failed;
    writers_opened_ = true;
    const size_t n = writer_paths_.size();
    writers_.resize(n);
    std::atomic<size_t> next{0};
    auto work = [&] {
      for (;;) {
        size_t s = next.fetch_add(1);
        if (s >= n || err.failed) return;
        auto& dst = writers_[s];
        dst.reserve(writer_paths_[s].size());
        for (const auto& p : writer_paths_[s]) {
          auto w = std::make_unique<BgzfWriter>(p, level_, pool_.get(), &err);
          if (!w->ok()) {
            err.set(str_printf("Error opening output file for writing: %s",
                               p.c_str()));
            return;
          }
          dst.push_back(std::move(w));
        }
      }
    };
    int nt = static_cast<int>(
        std::min<size_t>(4, std::max<size_t>(1, n / 16)));
    std::vector<std::thread> ts;
    for (int t = 0; t + 1 < nt; t++) ts.emplace_back(work);
    work();
    for (auto& t : ts) t.join();
    return !err.failed;
  }

  void configure(int bc_len, int nocall_budget, int skip_too_few,
                 const char* first_sample_id, const char* first_barcode,
                 const char* out_types, int n_out_types, int pack_masks) {
    bc_len_ = bc_len;
    pack_mode_ = pack_masks;  // 0 = raw bytes, 1 = 4-bit nibbles, 2 = 2-bit
    row_stride_ = pack_masks == 2   ? (bc_len + 3) / 4
                  : pack_masks == 1 ? (bc_len + 1) / 2
                                    : bc_len;
    nocall_budget_ = nocall_budget;
    skip_too_few_ = skip_too_few != 0;
    first_sample_id_ = first_sample_id;
    first_barcode_ = first_barcode;
    // out_types must come in the reference's fixed write order (T, B, M, C
    // filtered to the requested set; demux.rs:397-402)
    out_types_.assign(out_types, out_types + n_out_types);
  }

  // Parse up to `max_templates` records from input `i` into `ib`, scanning
  // IN PLACE over the slot arena: decompressed bytes land in the arena once
  // and RecEntry offsets point straight at them — no per-record copies (the
  // old path memcpy'd every record out of the scanner buffer).
  void parse_input_window(size_t i, InputBatch& ib, int64_t max_templates) {
    ib.reset();
    ParseState& st = *parse_states_[i];
    std::vector<uint8_t>& arena = ib.arena;
    const std::string& path = st.in->path();
    arena.insert(arena.end(), st.carry.begin(), st.carry.end());
    st.carry.clear();

    auto fail = [&](std::string msg) {
      ib.failed = true;
      ib.error = std::move(msg);
    };
    auto fill = [&]() -> bool {  // append ~1MB of decompressed input
      const size_t want = 1 << 20;
      size_t old = arena.size();
      arena.resize(old + want);
      size_t n = st.in->read(arena.data() + old, want);
      arena.resize(old + n);
      if (!st.in->ok()) {
        fail(str_printf("%s: read/decompress error", path.c_str()));
        return false;
      }
      if (n == 0) st.eof = true;
      return true;
    };

    size_t pos = 0;
    int64_t count = 0;
    while (count < max_templates) {
    rescan_record:
      size_t p = pos;
      size_t offs[4], lens[4];
      bool clean_eof = false;
      for (int li = 0; li < 4; li++) {
        const uint8_t* base = arena.data();
        const uint8_t* nl = static_cast<const uint8_t*>(
            p < arena.size() ? memchr(base + p, '\n', arena.size() - p)
                             : nullptr);
        if (nl == nullptr) {
          if (!st.eof) {
            if (!fill()) return;
            goto rescan_record;
          }
          if (arena.size() > p) {  // final line without trailing newline
            offs[li] = p;
            size_t l = arena.size() - p;
            lens[li] = (l > 0 && arena[p + l - 1] == '\r') ? l - 1 : l;
            p = arena.size();
            continue;
          }
          if (li == 0) {
            clean_eof = true;
            break;
          }
          fail(str_printf("%s: truncated FASTQ record", path.c_str()));
          return;
        }
        offs[li] = p;
        size_t l = nl - (base + p);
        lens[li] = (l > 0 && base[p + l - 1] == '\r') ? l - 1 : l;
        p = (nl - base) + 1;
      }
      if (clean_eof) break;
      const uint8_t* base = arena.data();
      if (lens[0] < 1 || base[offs[0]] != '@') {
        fail(str_printf("%s: FASTQ record header must start with '@'",
                        path.c_str()));
        return;
      }
      if (lens[2] < 1 || base[offs[2]] != '+') {
        fail(str_printf("%s: FASTQ separator line must start with '+'",
                        path.c_str()));
        return;
      }
      if (lens[1] != lens[3]) {
        fail(str_printf("%s: sequence and quality lengths differ (%zu vs %zu)",
                        path.c_str(), lens[1], lens[3]));
        return;
      }
      RecEntry e;
      e.head_off = static_cast<uint32_t>(offs[0] + 1);
      e.head_len = static_cast<uint32_t>(lens[0] - 1);
      e.seq_off = static_cast<uint32_t>(offs[1]);
      e.seq_len = static_cast<uint32_t>(lens[1]);
      e.qual_off = static_cast<uint32_t>(offs[3]);
      ib.recs.push_back(e);
      pos = p;
      count++;
    }
    // carry the unconsumed tail (bounded by one fill chunk) to next window
    if (pos < arena.size()) {
      st.carry.assign(arena.begin() + pos, arena.end());
      arena.resize(pos);
    }
  }

  // ---- per-template phase: skip/sync gates + barcode packing ----
  // Fills bc_out/flags_out/rmap with the emitted (non-skipped) templates;
  // returns the emitted count or -1 (error set).  *max_count_out reports the
  // raw record count of the window (0 == true EOF).
  int64_t gate_pack(BatchSlot& slot, uint8_t* bc_out, uint8_t* flags_out,
                    std::vector<int64_t>& rmap, int64_t* skipped_out,
                    int64_t* max_count_out,
                    std::vector<int32_t>* exc_rows = nullptr,
                    std::vector<uint8_t>* exc_bytes = nullptr) {
    const size_t n_in = parse_states_.size();
    rmap.clear();
    if (exc_rows) exc_rows->clear();
    if (exc_bytes) exc_bytes->clear();
    std::vector<uint8_t> raw_row(pack_mode_ == 2 ? bc_len_ : 0);
    int64_t max_count = 0;
    for (size_t i = 0; i < n_in; i++)
      max_count = std::max<int64_t>(max_count, slot.per_input[i].recs.size());

    int64_t count = 0;  // templates emitted into this batch
    int64_t skipped = 0;
    for (int64_t t = 0; t < max_count; t++) {
      size_t got = 0;
      bool too_short = false;
      for (size_t i = 0; i < n_in; i++) {
        InputBatch& ib = slot.per_input[i];
        if (t >= static_cast<int64_t>(ib.recs.size())) continue;
        got++;
        const RecEntry& e = ib.recs[t];
        if (static_cast<int32_t>(e.seq_len) < inputs_[i].min_len) {
          if (skip_too_few_) {
            too_short = true;
          } else {
            err.set(str_printf(
                "Read %.*s had too few bases to demux %u vs. %d needed in "
                "read structure %s.",
                static_cast<int>(e.head_len), ib.arena.data() + e.head_off,
                e.seq_len, inputs_[i].min_len,
                inputs_[i].structure_str.c_str()));
            return -1;
          }
        }
      }
      if (got == 0) break;
      if (too_short) {
        // template consumed but not demultiplexed (compacted out of batch)
        skipped++;
        continue;
      }
      if (got != n_in) {
        // list the present records' headers, same rendering as the Python
        // path (runtime/demux.py f-string of a bytes list, i.e. CPython
        // bytes repr) so the operator-facing contract matches byte-for-byte
        std::string heads = "[";
        for (size_t i = 0; i < n_in; i++) {
          const InputBatch& ib = slot.per_input[i];
          if (t >= static_cast<int64_t>(ib.recs.size())) continue;
          const RecEntry& e = ib.recs[t];
          if (heads.size() > 1) heads += ", ";
          heads += py_bytes_repr(ib.arena.data() + e.head_off, e.head_len);
        }
        heads += "]";
        err.set(str_printf("FASTQ sources out of sync at records: %s",
                           heads.c_str()));
        return -1;
      }

      uint8_t* bc_row = bc_out + count * row_stride_;
      int bc_pos = 0;
      bool bc_overflow = false;
      bool weird = false;  // 2-bit mode: any non-ACGT/U byte in the barcode
      int nocalls = 0;
      if (pack_mode_ == 2) memset(bc_row, 0, row_stride_);
      for (size_t i = 0; i < n_in; i++) {
        const InputBatch& ib = slot.per_input[i];
        const RecEntry& e = ib.recs[t];
        for (const SegmentDef& sd : inputs_[i].segments) {
          if (sd.kind != 'B') continue;
          uint32_t len = sd.length < 0 ? e.seq_len - sd.offset
                                       : static_cast<uint32_t>(sd.length);
          const uint8_t* p = ib.arena.data() + e.seq_off + sd.offset;
          for (uint32_t j = 0; j < len; j++) {
            uint8_t b = p[j];
            nocalls += kIupac.nocall[b];
            if (bc_pos < bc_len_) {
              if (pack_mode_ == 2) {
                // 2-bit ACGT codes, 4 per byte — quarter-width transfers;
                // rows with any ambiguous byte are flagged exceptional and
                // resolved host-side (see make_assign_fn packed2)
                int c = base_code2(b);
                if (c < 0)
                  weird = true;
                else
                  bc_row[bc_pos >> 2] |= static_cast<uint8_t>(
                      c << (2 * (bc_pos & 3)));
                raw_row[bc_pos] = b;
              } else if (pack_mode_ == 1) {
                // two 4-bit IUPAC masks per byte, low nibble first — halves
                // the host->device transfer (see make_assign_fn packed_masks)
                uint8_t m = kIupac.encode[b];
                if ((bc_pos & 1) == 0)
                  bc_row[bc_pos >> 1] = m;
                else
                  bc_row[bc_pos >> 1] |= static_cast<uint8_t>(m << 4);
              } else {
                bc_row[bc_pos] = b;
              }
              bc_pos++;
            } else {
              bc_overflow = true;
            }
          }
        }
      }
      uint8_t flag = 0;
      if (bc_overflow) {
        // longer than expected: reference panics unless the no-call gate
        // fires first (barcode_matching.rs:165-186)
        if (nocalls > nocall_budget_) {
          flag = 1;
          memset(bc_row, pack_mode_ == 2 ? 0 : (pack_mode_ == 1 ? 0x11 : 'A'),
                 row_stride_);
        } else {
          std::string obs;
          size_t obs_len = 0;
          for (size_t i = 0; i < n_in; i++) {
            const InputBatch& ib = slot.per_input[i];
            const RecEntry& e = ib.recs[t];
            for (const SegmentDef& sd : inputs_[i].segments) {
              if (sd.kind != 'B') continue;
              uint32_t len = sd.length < 0 ? e.seq_len - sd.offset
                                           : static_cast<uint32_t>(sd.length);
              const uint8_t* p = ib.arena.data() + e.seq_off + sd.offset;
              for (uint32_t j = 0; j < len; j++) {
                char c = kIupac.decode[kIupac.encode[p[j]]];
                obs += c ? c : '?';
                obs_len++;
              }
            }
          }
          err.set(str_printf(
              "Read barcode (%s) length (%zu) differs from expected barcode "
              "(%s) length (%d) for sample %s",
              obs.c_str(), obs_len, first_barcode_.c_str(), bc_len_,
              first_sample_id_.c_str()));
          return -1;
        }
      } else if (bc_pos < bc_len_) {
        flag = 1;  // too short overall: assign() -> None
        memset(bc_row, pack_mode_ == 2 ? 0 : (pack_mode_ == 1 ? 0x11 : 'A'),
               row_stride_);
      } else if (pack_mode_ == 2) {
        if (nocalls > nocall_budget_) {
          flag = 1;  // no-call gate applied host-side in 2-bit mode
        } else if (weird) {
          flag = 2;  // ambiguous bytes: resolved host-side from raw bytes
          if (exc_rows) {
            exc_rows->push_back(static_cast<int32_t>(count));
            exc_bytes->insert(exc_bytes->end(), raw_row.begin(),
                              raw_row.end());
          }
        }
      }
      flags_out[count] = flag;
      // record the source template index for routing (skipped templates
      // are compacted out of the emitted batch)
      rmap.push_back(t);
      count++;
    }

    *skipped_out = skipped;
    *max_count_out = max_count;
    return count;
  }

  // Scratch buffers reused across write_template calls (one per thread).
  struct WriteScratch {
    std::vector<uint8_t> rec_buf;
    std::vector<std::pair<const uint8_t*, size_t>> bc_segs, umi_segs;
#ifdef FQTK_ROUTE_PROF
    uint64_t t_segs = 0, t_head = 0, t_copy = 0, t_reserve = 0, n_recs = 0;
#endif
  };
#ifdef FQTK_ROUTE_PROF
#define FQTK_TSC(var) uint64_t var = __builtin_ia32_rdtsc()
#define FQTK_TADD(acc, t0) sc.acc += __builtin_ia32_rdtsc() - (t0)
#else
#define FQTK_TSC(var)
#define FQTK_TADD(acc, t0)
#endif

  // Formats and writes one template's requested segments to writer set
  // `idx` (header rewrite + 4-line records, in the fixed T/B/M/C order).
  // Returns false with err set on header-contract violations.
  bool write_template(const std::vector<InputBatch>& per_input, int64_t t,
                      int32_t idx, WriteScratch& sc) {
    const size_t n_in = per_input.size();
    auto& wset = writers_[idx];
    const InputBatch& ib0 = per_input[0];
    const RecEntry& e0 = ib0.recs[t];
    auto& bc_segs = sc.bc_segs;
    auto& umi_segs = sc.umi_segs;
    FQTK_TSC(tp0);
    bc_segs.clear();
    umi_segs.clear();
    for (size_t i = 0; i < n_in; i++) {
      const InputBatch& ib = per_input[i];
      const RecEntry& e = ib.recs[t];
      for (const SegmentDef& sd : inputs_[i].segments) {
        if (sd.kind != 'B' && sd.kind != 'M') continue;
        uint32_t len = sd.length < 0 ? e.seq_len - sd.offset
                                     : static_cast<uint32_t>(sd.length);
        const uint8_t* p = ib.arena.data() + e.seq_off + sd.offset;
        if (sd.kind == 'B')
          bc_segs.emplace_back(p, len);
        else
          umi_segs.emplace_back(p, len);
      }
    }
    size_t extra_len = 0;  // header growth bound: umis + barcodes + seps
    for (auto& s : bc_segs) extra_len += s.second + 1;
    for (auto& s : umi_segs) extra_len += s.second + 1;
    size_t head_max = 1 + e0.head_len + extra_len + 32;
    FQTK_TADD(t_segs, tp0);

    size_t w = 0;
    for (char ot : out_types_) {
      int read_num = 0;
      for (size_t i = 0; i < n_in; i++) {
        const InputBatch& ib = per_input[i];
        const RecEntry& e = ib.recs[t];
        for (const SegmentDef& sd : inputs_[i].segments) {
          if (sd.kind != ot) continue;
          read_num++;
          if (w >= wset.size()) {
            w++;
            continue;
          }
          uint32_t len = sd.length < 0 ? e.seq_len - sd.offset
                                       : static_cast<uint32_t>(sd.length);
          const uint8_t* seq = ib.arena.data() + e.seq_off + sd.offset;
          const uint8_t* qual = ib.arena.data() + e.qual_off + sd.offset;
          size_t max_rec = head_max + 2 * len + 8;
          std::string herr;
          if (max_rec < kBgzfBlockInput) {
            // format directly into the writer's block buffer
            FQTK_TSC(tr0);
            uint8_t* base = wset[w]->reserve(max_rec);
            FQTK_TADD(t_reserve, tr0);
            FQTK_TSC(th0);
            int64_t h = rewrite_header_buf(base,
                                           ib0.arena.data() + e0.head_off,
                                           e0.head_len, read_num, bc_segs,
                                           umi_segs, &herr);
            FQTK_TADD(t_head, th0);
            if (h < 0) {
              err.set(herr);
              return false;
            }
            FQTK_TSC(tc0);
            uint8_t* p = base + h;
            *p++ = '\n';
            memcpy(p, seq, len);
            p += len;
            *p++ = '\n';
            *p++ = '+';
            *p++ = '\n';
            memcpy(p, qual, len);
            p += len;
            *p++ = '\n';
            wset[w]->commit(p - base);
            FQTK_TADD(t_copy, tc0);
#ifdef FQTK_ROUTE_PROF
            sc.n_recs++;
#endif
          } else {  // huge record fallback via the copy path
            auto& rec_buf = sc.rec_buf;
            rec_buf.clear();
            if (!rewrite_header(rec_buf, ib0.arena.data() + e0.head_off,
                                e0.head_len, read_num, bc_segs, umi_segs,
                                &herr)) {
              err.set(herr);
              return false;
            }
            rec_buf.push_back('\n');
            rec_buf.insert(rec_buf.end(), seq, seq + len);
            rec_buf.push_back('\n');
            rec_buf.push_back('+');
            rec_buf.push_back('\n');
            rec_buf.insert(rec_buf.end(), qual, qual + len);
            rec_buf.push_back('\n');
            wset[w]->write(rec_buf.data(), rec_buf.size());
          }
          w++;
        }
      }
    }
    return true;
  }

  // Routes the subset of records whose assigned sample index % n_parts ==
  // part.  Writer sets touched by different parts are disjoint.
  void route_partition(BatchSlot& slot, const std::vector<int64_t>& rmap,
                       const int32_t* assigned, int64_t n, int part,
                       int n_parts) {
    uint64_t cpu0 = thread_cpu_ns();
    uint64_t don0 = CompressorPool::tl_donated();
    WriteScratch sc;
    for (int64_t r = 0; r < n; r++) {
      int32_t idx = assigned[r];
      if (idx % n_parts != part) continue;
      if (!write_template(slot.per_input, rmap[r], idx, sc)) break;
    }
    // compress jobs stolen inside submit() (queue-full backpressure) are
    // charged to the pool's busy_ns, not to routing
    route_ns_ +=
        thread_cpu_ns() - cpu0 - (CompressorPool::tl_donated() - don0);
#ifdef FQTK_ROUTE_PROF
    if (sc.n_recs)
      fprintf(stderr,
              "ROUTE_PROF recs=%llu segs=%llu head=%llu reserve=%llu "
              "copy=%llu (tsc)\n",
              (unsigned long long)sc.n_recs, (unsigned long long)sc.t_segs,
              (unsigned long long)sc.t_head, (unsigned long long)sc.t_reserve,
              (unsigned long long)sc.t_copy);
#endif
  }

  bool finish() {
    // two-phase drain: submit every writer's final partial block first so
    // the pool compresses them all in parallel, THEN wait per writer
    for (auto& ws : writers_)
      for (auto& w : ws) w->flush_final();
    for (auto& ws : writers_)
      for (auto& w : ws) w->close();
    if (pool_) pool_->stop();
    return !err.failed;
  }

  // -------------------------------------------------------------------------
  // pipelined mode: C++ owns the whole batch loop.  Persistent per-input
  // parse threads free-run over a ring of windows; the last thread to finish
  // a window runs the gate/pack phase inline and publishes it; a dedicated
  // route thread consumes device assignments in window order.  Python's only
  // job between pipe_acquire() and pipe_submit() is the device matcher call.
  // -------------------------------------------------------------------------

  // Window-ring depth: how far parse may run ahead of route/compress.
  // 4 absorbs normal jitter; FQTK_PIPE_SLOTS widens it for experiments
  // (deeper rings buffer compress-queue bursts at small windows).
  int pipe_slots_ = 4;
  //: releases parse threads from compressor drain-assist at shutdown
  std::atomic<bool> drain_quit_{false};
  //: fractional first windows (host-matcher runs): route/compress start
  //: within milliseconds instead of waiting a full window's parse+gate.
  //: Off for device-matcher runs, whose jitted programs are per-shape.
  bool pipe_ramp_ = false;

  int64_t pipe_window_target(int64_t w) const {
    if (!pipe_ramp_ || w >= 3) return pipe_batch_;
    // never above pipe_batch_: the slot buffers are sized for it
    return std::min<int64_t>(
        pipe_batch_, std::max<int64_t>(1024, pipe_batch_ >> (3 - w)));
  }

  struct PipeSlot {
    BatchSlot batch;
    std::vector<int64_t> rmap;
    std::vector<uint8_t> bc;       // [pipe_batch, row_stride]
    std::vector<uint8_t> flags;    // per emitted template
    std::vector<int32_t> assigned; // filled by pipe_submit
    std::vector<int32_t> exc_rows; // 2-bit mode: rows needing host resolve
    std::vector<uint8_t> exc_bytes;  // [n_exc, bc_len] raw barcode bytes
    int64_t n = 0;                 // emitted templates
    int64_t max_count = 0;         // raw records in the window (0 == EOF)
    int64_t skipped = 0;
    int64_t ready_for = 0;         // next window this slot may hold
    int inputs_done = 0;
  };

  bool pipe_start(int64_t batch, bool ramp) {
    if (err.failed || pipe_started_) return false;
    pipe_started_ = true;
    pipe_batch_ = batch;
    pipe_ramp_ = ramp;
    if (const char* ps_env = getenv("FQTK_PIPE_SLOTS")) {
      int v = atoi(ps_env);
      if (v >= 2 && v <= 64) pipe_slots_ = v;
    }
    // Block-parallel BGZF inflate is OFF by default: interleaved A/B on the
    // 4-core bench host measured it 10-20% SLOWER end-to-end (dec=2: 3.70M
    // vs dec=1: 4.19M median reads/s single-end; same ordering on a level-9
    // recompressed input where inflate is 5x costlier) — the out-of-order
    // done-map copy + cv round-trips exceed libdeflate's member inflate
    // cost at any level tried.  FQTK_DECODE_THREADS=N re-enables it for
    // hosts where inflate genuinely starves a lone parse thread.
    int dec = 1;
    if (const char* de = getenv("FQTK_DECODE_THREADS")) {
      int v = atoi(de);
      if (v >= 1 && v <= 8) dec = v;
    }
    if (dec > 1)
      for (auto& st : parse_states_) st->in->set_decode_threads(dec);
    counts_.assign(writer_paths_.size(), 0);
    pslots_.reset(new PipeSlot[pipe_slots_]);
    for (int s = 0; s < pipe_slots_; s++) {
      pslots_[s].batch.per_input.resize(parse_states_.size());
      pslots_[s].bc.assign(
          static_cast<size_t>(batch) * row_stride_,
          pack_mode_ == 2 ? 0 : (pack_mode_ == 1 ? 0x11 : 'A'));
      pslots_[s].flags.assign(batch, 0);
      pslots_[s].assigned.assign(batch, 0);
      pslots_[s].ready_for = s;
    }
    // writer opens overlap the pipeline fill: the route worker waits for
    // writers_ready_ before touching writers_ (first window needs ~50ms of
    // parse anyway, which covers ~200 fopens on 4 threads)
    opener_thread_ = std::thread([this] {
      bool ok = open_writers();
      std::lock_guard<std::mutex> lk(pmu_);
      writers_ready_ = true;
      if (!ok) pipe_stop_ = true;
      pipe_notify_all();
    });
    route_thread_ = std::thread([this] { pipe_route_worker(); });
    if (fused_matcher_)
      assign_thread_ = std::thread([this] { pipe_assign_worker(); });
    for (size_t i = 0; i < parse_states_.size(); i++)
      parse_threads_.emplace_back([this, i] {
#if defined(__linux__)
        // Experimental (A/B'd): pin parse thread i to
        // core i%ncores so the per-input scan streams keep cache/core
        // affinity across windows instead of migrating under load.
        if (getenv("FQTK_PIN_PARSE") != nullptr) {
          long nc = sysconf(_SC_NPROCESSORS_ONLN);
          if (nc > 0) {
            cpu_set_t set;
            CPU_ZERO(&set);
            CPU_SET(static_cast<int>(i % nc), &set);
            sched_setaffinity(static_cast<pid_t>(syscall(SYS_gettid)),
                              sizeof(set), &set);
          }
        }
#endif
        pipe_parse_worker(i);
      });
    return true;
  }

  // After a parse thread's own stage ends (true EOF, not an error stop),
  // it joins the compressor pool until the run finishes: the end-of-run
  // drain + writer-close flush otherwise runs on the compressor threads
  // alone while parse cores idle (a fixed ~0.8-1.0 core-s bubble per run
  // on a 4-core host).
  void pipe_parse_drain_assist() {
    if (const char* env = getenv("FQTK_DRAIN_ASSIST"))
      if (env[0] == '0') return;  // A/B kill switch
    if (pool_ && !err.failed) pool_->assist(drain_quit_);
  }

  void pipe_parse_worker(size_t i) {
    const size_t n_in = parse_states_.size();
    for (int64_t w = 0;; w++) {
      PipeSlot* ps = &pslots_[w % pipe_slots_];
      {
        uint64_t w0 = wall_ns();
        std::unique_lock<std::mutex> lk(pmu_);
        auto ready = [&] {
          return pipe_stop_ || pipe_done_ || ps->ready_for == w;
        };
        // Stall-assist: a parse thread blocked on the window ring (downstream
        // backpressure — route/compress is behind) compresses instead of
        // parking.  Unlike the route thread, new jobs CAN appear while it
        // waits (route is running), so the empty-queue fallback is a short
        // timed wait rather than an unbounded one.
        if (stall_assist_) {
          while (!ready()) {
            lk.unlock();
            bool did = pool_ && pool_->try_assist_one();
            lk.lock();
            if (!did && !ready())
              slot_cv_.wait_for(lk, std::chrono::microseconds(500));
          }
        } else {
          slot_cv_.wait(lk, ready);
        }
        parse_stall_ns_ += wall_ns() - w0;
        if (pipe_stop_) return;
        if (pipe_done_) {
          lk.unlock();
          pipe_parse_drain_assist();
          return;
        }
      }
      uint64_t t0 = thread_cpu_ns();
      parse_input_window(i, ps->batch.per_input[i], pipe_window_target(w));
      parse_ns_ += thread_cpu_ns() - t0;
      bool last = false;
      {
        std::lock_guard<std::mutex> lk(pmu_);
        if (ps->batch.per_input[i].failed) {
          err.set(ps->batch.per_input[i].error);
          pipe_stop_ = true;
          pipe_notify_all();
          return;
        }
        last = (++ps->inputs_done == static_cast<int>(n_in));
      }
      if (last) {
        uint64_t g0 = thread_cpu_ns();
        int64_t sk = 0, mx = 0;
        int64_t n = gate_pack(ps->batch, ps->bc.data(), ps->flags.data(),
                              ps->rmap, &sk, &mx, &ps->exc_rows,
                              &ps->exc_bytes);
        gate_ns_ += thread_cpu_ns() - g0;
        std::unique_lock<std::mutex> lk(pmu_);
        if (n < 0) {
          pipe_stop_ = true;
          pipe_notify_all();
          return;
        }
        ps->n = n;
        ps->skipped = sk;
        ps->max_count = mx;
        if (fused_matcher_) {
          // fused mode: no Python acquire — route gated windows through the
          // engine's own assign thread.  Gate completions are strictly
          // window-ordered (each input parses windows in order and the gate
          // runs on the last finisher), so assign_q_ preserves output order.
          fused_skipped_ += sk;
          if (mx == 0) {
            pipe_done_ = true;  // true EOF window: nothing to assign/route
          } else if (n > 0) {
            fused_gated_++;
            assign_q_.push_back(static_cast<int>(w % pipe_slots_));
            assign_cv_.notify_one();
          } else {
            pipe_release_slot(ps);  // all templates skipped: recycle
          }
          routed_cv_.notify_all();  // progress/skip totals moved
          if (pipe_done_) {
            slot_cv_.notify_all();
            lk.unlock();
            pipe_parse_drain_assist();
            return;
          }
          continue;
        }
        ready_q_.push_back(static_cast<int>(w % pipe_slots_));
        if (mx == 0) pipe_done_ = true;  // true EOF window
        ready_cv_.notify_all();
        if (pipe_done_) {
          slot_cv_.notify_all();
          lk.unlock();
          pipe_parse_drain_assist();
          return;
        }
      }
    }
  }

  void pipe_release_slot(PipeSlot* ps) {
    // caller holds pmu_
    ps->ready_for += pipe_slots_;
    ps->inputs_done = 0;
    slot_cv_.notify_all();
  }

  // Fused host-matcher mode: when the placement policy picks a HOST
  // matcher, the Python driver's per-window acquire -> ctypes assign ->
  // submit round trip is pure overhead (one GIL round trip per window).
  // Registering the matcher here moves assignment into a dedicated engine
  // thread between gate_pack and route: gated windows flow through
  // assign_q_ in window order and Python only polls progress counters.
  // Must be called before pipe_start; `call` is a trampoline set by the C
  // API (SmallKMatcher/BigKMatcher are defined below this class).
  bool pipe_fuse_host_matcher(void* matcher,
                              void (*call)(void*, const uint8_t*, int64_t,
                                           int64_t, int32_t*, int),
                              int n_threads) {
    if (pipe_started_ || !matcher || !call) return false;
    fused_matcher_ = matcher;
    fused_call_ = call;
    fused_threads_ = std::max(1, n_threads);
    return true;
  }

  void pipe_assign_worker() {
    for (;;) {
      int s;
      {
        std::unique_lock<std::mutex> lk(pmu_);
        assign_cv_.wait(lk, [&] {
          return !assign_q_.empty() || pipe_stop_ || assign_finishing_;
        });
        if (assign_q_.empty()) {
          if (pipe_stop_ || assign_finishing_) return;
          continue;
        }
        s = assign_q_.front();
        assign_q_.pop_front();
      }
      PipeSlot* ps = &pslots_[s];
      uint64_t t0 = thread_cpu_ns();
      fused_call_(fused_matcher_, ps->bc.data(), ps->n, row_stride_,
                  ps->assigned.data(), fused_threads_);
      host_assign_ns_ += thread_cpu_ns() - t0;
      std::lock_guard<std::mutex> lk(pmu_);
      submitted_++;
      fused_total_ += ps->n;
      route_q_.push_back(s);
      route_cv_.notify_one();
      routed_cv_.notify_all();  // progress for pipe_fused_poll
    }
  }

  // True when the fused pipeline has fully drained: EOF gate published,
  // every gated window assigned (submitted) and routed.  Caller holds pmu_.
  bool fused_drained() const {
    return pipe_done_ && fused_gated_ == submitted_ && submitted_ == routed_;
  }

  // Blocks up to timeout_ms for fused-pipeline progress.  Returns 1 when
  // drained, 0 on timeout (more work pending), -1 on error/stop; writes the
  // running template/skip totals either way.
  int pipe_fused_poll(int timeout_ms, int64_t* total, int64_t* skipped) {
    std::unique_lock<std::mutex> lk(pmu_);
    auto done = [&] { return pipe_stop_ || err.failed || fused_drained(); };
    if (!done())
      routed_cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), done);
    *total = fused_total_;
    *skipped = fused_skipped_;
    if (err.failed || pipe_stop_) return -1;
    return fused_drained() ? 1 : 0;
  }

  void pipe_route_worker() {
    {
      // writers open concurrently with the pipeline fill (see pipe_start)
      std::unique_lock<std::mutex> lk(pmu_);
      routed_cv_.wait(lk, [&] { return writers_ready_ || pipe_stop_; });
      if (pipe_stop_) return;
    }
    for (;;) {
      int s;
      {
        uint64_t w0 = wall_ns();
        std::unique_lock<std::mutex> lk(pmu_);
        auto ready = [&] {
          return !route_q_.empty() || pipe_stop_ || route_finishing_;
        };
        // Stall-assist: while waiting for the next submitted window, drain
        // the compress backlog this thread produced routing the previous
        // one.  Mid-run the route side is the only job producer, so once
        // the queue is empty a plain blocking wait is safe (no new jobs
        // can appear until route runs again).
        if (stall_assist_) {
          while (!ready()) {
            lk.unlock();
            bool did = pool_ && pool_->try_assist_one();
            lk.lock();
            if (!did) {
              route_cv_.wait(lk, ready);
              break;
            }
          }
        } else {
          route_cv_.wait(lk, ready);
        }
        route_stall_ns_ += wall_ns() - w0;
        if (route_q_.empty()) {
          if (pipe_stop_ || route_finishing_) return;
          continue;
        }
        s = route_q_.front();
        route_q_.pop_front();
      }
      PipeSlot* ps = &pslots_[s];
      const int32_t unmatched = static_cast<int32_t>(writers_.size()) - 1;
      bool bad = false;
      for (int64_t r = 0; r < ps->n; r++) {
        int32_t a = ps->assigned[r];
        if (ps->flags[r] == 1) a = unmatched;  // host gates force unmatched
        if (a < 0 || a > unmatched) {
          err.set(str_printf("route: assignment %d out of range", a));
          bad = true;
          break;
        }
        ps->assigned[r] = a;
        counts_[a]++;
      }
      if (!bad) {
        const int n_threads = route_threads_;
        if (n_threads <= 1) {
          route_partition(ps->batch, ps->rmap, ps->assigned.data(), ps->n, 0,
                          1);
        } else {
          // spawn n-1 helpers; this thread routes partition n-1 itself
          std::vector<std::thread> ts;
          for (int j = 0; j < n_threads - 1; j++)
            ts.emplace_back([&, j] {
              route_partition(ps->batch, ps->rmap, ps->assigned.data(), ps->n,
                              j, n_threads);
            });
          route_partition(ps->batch, ps->rmap, ps->assigned.data(), ps->n,
                          n_threads - 1, n_threads);
          for (auto& t : ts) t.join();
        }
      }
      std::lock_guard<std::mutex> lk(pmu_);
      if (bad || err.failed) {
        pipe_stop_ = true;
        pipe_notify_all();
        return;
      }
      routed_++;
      pipe_release_slot(ps);
      routed_cv_.notify_all();
    }
  }

  void pipe_notify_all() {
    slot_cv_.notify_all();
    ready_cv_.notify_all();
    route_cv_.notify_all();
    routed_cv_.notify_all();
    assign_cv_.notify_all();
  }

  // Reference-architecture measurement mode; defined after the RefProxy
  // helper classes below.  Returns total templates or -1 (err set).
  int64_t refproxy_run(const uint8_t* barcodes, int k, int max_mm, int delta,
                       int reader_chunk);

  // Blocks until a non-empty window is ready.  Returns its template count
  // (>0), 0 on EOF, -1 on error.  *skipped_out accumulates the skip counts
  // of this window plus any all-skip windows consumed along the way;
  // *slot_out/*bc_out expose the engine-owned packed barcode matrix.
  int64_t pipe_acquire(int32_t* slot_out, const uint8_t** bc_out,
                       int64_t* skipped_out) {
    int64_t skips = 0;
    for (;;) {
      int s;
      {
        std::unique_lock<std::mutex> lk(pmu_);
        auto ready = [&] { return !ready_q_.empty() || pipe_stop_; };
        // Stall-assist: the caller (the Python driver thread, GIL released)
        // spends most of its wall time here waiting for parse+gate; donate
        // it to the compress backlog.  Timed fallback: route produces jobs
        // concurrently, so an empty queue can refill while we park.
        if (stall_assist_) {
          while (!ready()) {
            lk.unlock();
            bool did = pool_ && pool_->try_assist_one();
            lk.lock();
            if (!did && !ready())
              ready_cv_.wait_for(lk, std::chrono::microseconds(500));
          }
        } else {
          ready_cv_.wait(lk, ready);
        }
        if (ready_q_.empty()) {
          *skipped_out = skips;
          return -1;  // error path
        }
        s = ready_q_.front();
        ready_q_.pop_front();
      }
      PipeSlot* ps = &pslots_[s];
      skips += ps->skipped;
      if (ps->max_count == 0) {  // EOF window
        *skipped_out = skips;
        return 0;
      }
      if (ps->n == 0) {  // all templates skipped: keep scanning
        std::lock_guard<std::mutex> lk(pmu_);
        pipe_release_slot(ps);
        continue;
      }
      *slot_out = s;
      *bc_out = ps->bc.data();
      *skipped_out = skips;
      return ps->n;
    }
  }

  // Exceptional rows of an acquired 2-bit-mode window: returns count and
  // exposes the row indices + raw barcode bytes for host-side resolution.
  int64_t pipe_exceptional(int32_t slot, const int32_t** rows_out,
                           const uint8_t** bytes_out) {
    PipeSlot* ps = &pslots_[slot];
    *rows_out = ps->exc_rows.data();
    *bytes_out = ps->exc_bytes.data();
    return static_cast<int64_t>(ps->exc_rows.size());
  }

  bool pipe_submit(int32_t slot, const int32_t* assigned, int64_t n) {
    PipeSlot* ps = &pslots_[slot];
    if (n != ps->n) {
      err.set("pipe_submit: assignment count mismatch");
      return false;
    }
    memcpy(ps->assigned.data(), assigned, n * sizeof(int32_t));
    std::lock_guard<std::mutex> lk(pmu_);
    submitted_++;
    route_q_.push_back(slot);
    route_cv_.notify_one();
    return true;
  }

  bool pipe_finish() {
    {
      // wait for all submitted windows to be routed (fused mode: also for
      // every gated window to clear the assign queue first)
      std::unique_lock<std::mutex> lk(pmu_);
      routed_cv_.wait(lk, [&] {
        if (pipe_stop_ || err.failed) return true;
        if (fused_matcher_) return fused_drained();
        return routed_ == submitted_;
      });
      route_finishing_ = true;
      assign_finishing_ = true;
      pipe_stop_ = pipe_stop_ || err.failed;
      pipe_notify_all();
    }
    if (opener_thread_.joinable()) opener_thread_.join();
    if (assign_thread_.joinable()) assign_thread_.join();
    if (route_thread_.joinable()) route_thread_.join();
    // Parse threads may be drain-assisting the compressor pool — close
    // the writers (which submits every final partial block) and stop the
    // pool FIRST so the assistance covers the flush, then reap them.
    bool ok = finish();
    drain_quit_.store(true);
    if (pool_) pool_->wake_assist();
    for (auto& t : parse_threads_) t.join();
    parse_threads_.clear();
    return ok;
  }

  void pipe_join() {
    drain_quit_.store(true);
    if (pool_) pool_->wake_assist();
    for (auto& t : parse_threads_) t.join();
    parse_threads_.clear();
    if (opener_thread_.joinable()) opener_thread_.join();
    if (assign_thread_.joinable()) assign_thread_.join();
    if (route_thread_.joinable()) route_thread_.join();
  }

  void pipe_teardown() {
    if (!pipe_started_) return;
    {
      std::lock_guard<std::mutex> lk(pmu_);
      pipe_stop_ = true;
      route_finishing_ = true;
      pipe_notify_all();
    }
    pipe_join();
  }

  ~DemuxEngine() { pipe_teardown(); }

  void get_counts(int64_t* out, int64_t n) const {
    for (int64_t i = 0; i < n && i < static_cast<int64_t>(counts_.size()); i++)
      out[i] = counts_[i];
  }

  // [parse_s (sum over input threads), gate_pack_s, route_s,
  //  compress_s (sum over workers), compress_in_bytes, compress_out_bytes,
  //  parse_stall_s (wall, sum over input threads: waiting for a free window
  //  slot — downstream backpressure), route_stall_s (wall: route thread
  //  waiting for an assigned window — upstream starvation)]
  void get_stats(double* out, int n) const {
    double vals[10] = {
        parse_ns_.load() * 1e-9,
        gate_ns_.load() * 1e-9,
        route_ns_.load() * 1e-9,
        pool_ ? pool_->busy_ns.load() * 1e-9 : 0.0,
        pool_ ? static_cast<double>(pool_->bytes_in.load()) : 0.0,
        pool_ ? static_cast<double>(pool_->bytes_out.load()) : 0.0,
        parse_stall_ns_.load() * 1e-9,
        route_stall_ns_.load() * 1e-9,
        // subset of compress_s donated by stalled/stolen pipeline threads
        pool_ ? pool_->donated_ns.load() * 1e-9 : 0.0,
        // fused host-matcher CPU (the engine assign thread; NOT part of
        // the assign-free IO ceiling)
        host_assign_ns_.load() * 1e-9,
    };
    for (int i = 0; i < n && i < 10; i++) out[i] = vals[i];
  }

 private:
  std::vector<InputDef> inputs_;
  std::vector<std::unique_ptr<ParseState>> parse_states_;
  // NB: pool_ declared before the writer containers below so it is
  // destroyed after them (writers submit their final blocks on close).
  std::unique_ptr<CompressorPool> pool_;
  int level_ = 5;
  std::vector<std::string> current_paths_;
  std::vector<std::vector<std::string>> writer_paths_;
  bool writers_opened_ = false;
  bool writers_ready_ = false;  // guarded by pmu_ in pipelined mode
  std::thread opener_thread_;
  std::vector<std::vector<std::unique_ptr<BgzfWriter>>> writers_;
  int bc_len_ = 0;
  int route_threads_ = 1;
  bool stall_assist_ = false;
  int row_stride_ = 0;
  int pack_mode_ = 0;
  int nocall_budget_ = 0;
  bool skip_too_few_ = false;
  std::string first_sample_id_, first_barcode_;
  std::string out_types_;

  // ---- pipelined-mode state ----
  bool pipe_started_ = false;
  int64_t pipe_batch_ = 0;
  std::unique_ptr<PipeSlot[]> pslots_;
  std::vector<std::thread> parse_threads_;
  std::thread route_thread_;
  // ---- fused host-matcher state (see pipe_fuse_host_matcher) ----
  void* fused_matcher_ = nullptr;
  void (*fused_call_)(void*, const uint8_t*, int64_t, int64_t, int32_t*,
                      int) = nullptr;
  int fused_threads_ = 1;
  std::thread assign_thread_;
  std::deque<int> assign_q_;
  std::condition_variable assign_cv_;
  bool assign_finishing_ = false;
  int64_t fused_gated_ = 0, fused_total_ = 0, fused_skipped_ = 0;
  std::atomic<uint64_t> host_assign_ns_{0};
  std::mutex pmu_;
  std::condition_variable slot_cv_;    // a slot became free for its next window
  std::condition_variable ready_cv_;   // a window became ready for acquire
  std::condition_variable route_cv_;   // a window was submitted for routing
  std::condition_variable routed_cv_;  // a window finished routing
  std::deque<int> ready_q_;            // slots ready for acquire (window order)
  std::deque<int> route_q_;            // slots submitted for routing (FIFO)
  bool pipe_done_ = false;             // EOF window published
  bool pipe_stop_ = false;             // error / teardown
  bool route_finishing_ = false;
  int64_t submitted_ = 0, routed_ = 0;
  std::vector<int64_t> counts_;  // per-writer-set template counts
  std::atomic<uint64_t> parse_ns_{0}, gate_ns_{0}, route_ns_{0};
  std::atomic<uint64_t> parse_stall_ns_{0}, route_stall_ns_{0};
};

// ---------------------------------------------------------------------------
// subsample engine (reference ``subsample.rs:194-305`` semantics: lockstep
// reads, verbatim pass-through of kept records, name-sync vs file 0)
// ---------------------------------------------------------------------------

std::pair<const uint8_t*, size_t> base_read_name(const uint8_t* head,
                                                 size_t len) {
  size_t name_end = len;
  for (size_t i = 0; i < len; i++) {
    if (head[i] == ' ' || head[i] == '\t') {
      name_end = i;
      break;
    }
  }
  if (name_end >= 2 && head[name_end - 2] == '/' &&
      (head[name_end - 1] == '1' || head[name_end - 1] == '2'))
    return {head, name_end - 2};
  return {head, name_end};
}

class SubsampleEngine {
 public:
  ErrorState err;

  bool init(int n_threads, int compression_level) {
    pool_ = std::make_unique<CompressorPool>(std::max(1, n_threads),
                                             std::max(8, n_threads * 50));
    level_ = compression_level;
    return true;
  }

  bool add_input(const char* in_path, const char* out_path) {
    auto in = std::make_unique<InputStream>(in_path);
    if (!in->ok()) {
      err.set(str_printf("Failed to open \"%s\"", in_path));
      return false;
    }
    scanners_.push_back(std::make_unique<FastqScanner>(std::move(in)));
    auto w = std::make_unique<BgzfWriter>(out_path, level_, pool_.get(), &err);
    if (!w->ok()) {
      err.set(str_printf("Failed to open output \"%s\"", out_path));
      return false;
    }
    writers_.push_back(std::move(w));
    return true;
  }

  // parallel: one thread per input in process_chunk (the keep mask is
  // pre-drawn, so inputs only couple through the post-chunk sync/name
  // checks).  false reproduces the reference's serial lockstep loop —
  // used as the measured architecture proxy by bench.py.
  void configure(bool check_names, bool parallel) {
    check_names_ = check_names && scanners_.size() > 1;
    parallel_ = parallel && scanners_.size() > 1;
    // Decode-ahead is opt-in here for the same reason as the demux
    // pipeline (see pipe_start): measured SLOWER on the 4-core bench host
    // at every compression level tried.
    int dec = 1;
    if (const char* de = getenv("FQTK_DECODE_THREADS")) {
      int v = atoi(de);
      if (v >= 1 && v <= 8) dec = v;
    }
    if (dec > 1)
      for (auto& sc : scanners_) sc->stream()->set_decode_threads(dec);
  }

  // Process up to n record sets with the given keep mask; returns the number
  // consumed (0 == EOF), -1 on error.  total_kept_out accumulates kept sets.
  int64_t process_chunk(const uint8_t* keep_mask, int64_t n,
                        int64_t* kept_out) {
    if (err.failed) return -1;
    if (parallel_) return process_chunk_parallel(keep_mask, n, kept_out);
    // subtract compress CPU donated via queue-full steals (run_job charges
    // it to pool busy_ns) so work/compress never double-count — same
    // accounting as the demux route path
    uint64_t t0 = thread_cpu_ns();
    uint64_t don0 = CompressorPool::tl_donated();
    int64_t r = process_chunk_serial(keep_mask, n, kept_out);
    work_ns_ +=
        thread_cpu_ns() - t0 - (CompressorPool::tl_donated() - don0);
    return r;
  }

  int64_t process_chunk_serial(const uint8_t* keep_mask, int64_t n,
                               int64_t* kept_out) {
    const size_t n_in = scanners_.size();
    std::vector<RecordView> recs(n_in);
    int64_t consumed = 0;
    int64_t kept = 0;
    std::vector<uint8_t> rec_buf;
    std::vector<uint8_t> expected_name;  // file 0's base name, per record
    for (; consumed < n; consumed++) {
      bool keep = keep_mask[consumed] != 0;
      size_t got = 0;
      for (size_t i = 0; i < n_in; i++) {
        int r = scanners_[i]->next(&recs[i]);
        if (r < 0) {
          err.set(scanners_[i]->error_msg());
          return -1;
        }
        if (r == 0) continue;
        got++;
        if (keep) {
          if (check_names_) {
            auto name = base_read_name(recs[i].head, recs[i].head_len);
            if (i == 0) {
              expected_name.assign(name.first, name.first + name.second);
            } else if (name.second != expected_name.size() ||
                       memcmp(name.first, expected_name.data(),
                              name.second) != 0) {
              err.set(str_printf(
                  "Read name mismatch at read %lld: file 0=\"%s\", file "
                  "%zu=\"%s\"",
                  static_cast<long long>(total_read_ + 1),
                  std::string(expected_name.begin(), expected_name.end())
                      .c_str(),
                  i,
                  std::string(reinterpret_cast<const char*>(name.first),
                              name.second)
                      .c_str()));
              return -1;
            }
          }
          const RecordView& rec = recs[i];
          const size_t sz = 1 + rec.head_len + 1 + rec.seq_len + 1 +
                            rec.plus_len + 1 + rec.qual_len + 1;
          if (sz < kBgzfBlockInput) {
            // single-copy emit straight into the BGZF block buffer (same
            // fast path as the parallel worker)
            uint8_t* p = writers_[i]->reserve(sz);
            *p++ = '@';
            memcpy(p, rec.head, rec.head_len);
            p += rec.head_len;
            *p++ = '\n';
            memcpy(p, rec.seq, rec.seq_len);
            p += rec.seq_len;
            *p++ = '\n';
            memcpy(p, rec.plus, rec.plus_len);
            p += rec.plus_len;
            *p++ = '\n';
            memcpy(p, rec.qual, rec.qual_len);
            p += rec.qual_len;
            *p++ = '\n';
            writers_[i]->commit(sz);
          } else {
            rec_buf.clear();
            rec_buf.push_back('@');
            rec_buf.insert(rec_buf.end(), rec.head, rec.head + rec.head_len);
            rec_buf.push_back('\n');
            rec_buf.insert(rec_buf.end(), rec.seq, rec.seq + rec.seq_len);
            rec_buf.push_back('\n');
            rec_buf.insert(rec_buf.end(), rec.plus, rec.plus + rec.plus_len);
            rec_buf.push_back('\n');
            rec_buf.insert(rec_buf.end(), rec.qual, rec.qual + rec.qual_len);
            rec_buf.push_back('\n');
            writers_[i]->write(rec_buf.data(), rec_buf.size());
          }
        }
      }
      if (got == 0) break;
      if (got != n_in) {
        err.set(str_printf(
            "FASTQ files are out of sync: %zu of %zu files had a record at "
            "read %lld",
            got, n_in, static_cast<long long>(total_read_ + 1)));
        return -1;
      }
      total_read_++;
      if (keep) kept++;
    }
    *kept_out = kept;
    return consumed;
  }

  // Parallel chunk: one thread per input.  The keep decisions are pre-drawn
  // (mask), so the only cross-input coupling — lockstep sync and read-name
  // equality — moves to cheap post-join checks: each thread records how far
  // it got plus the base names of its KEPT records, and the main thread
  // verifies equal progress and memcmp-equal names afterwards.  Per-writer
  // ordering is preserved trivially (each writer is owned by one thread).
  // On a sync/name error some threads may already have written records the
  // serial loop would not have reached; the run fails fast either way and
  // the error text is identical.
  int64_t process_chunk_parallel(const uint8_t* keep_mask, int64_t n,
                                 int64_t* kept_out) {
    const size_t n_in = scanners_.size();
    struct PerInput {
      int64_t consumed = 0;
      uint64_t end_wall = 0;  // when this worker finished its chunk loop
      std::string error;
      std::vector<uint8_t> names;     // kept records' base names, packed
      std::vector<uint32_t> name_end; // end offset per kept record
    };
    std::vector<PerInput> st(n_in);
    auto work = [&](size_t i) {
      uint64_t t0 = thread_cpu_ns();
      uint64_t don0 = CompressorPool::tl_donated();
      auto& s = st[i];
      RecordView rec;
      std::vector<uint8_t> rec_buf;
      for (int64_t r = 0; r < n; r++) {
        int rc = scanners_[i]->next(&rec);
        if (rc < 0) {
          s.error = scanners_[i]->error_msg();
          work_ns_ += thread_cpu_ns() - t0 -
                      (CompressorPool::tl_donated() - don0);
          return;
        }
        if (rc == 0) break;
        s.consumed++;
        if (keep_mask[r] == 0) continue;
        if (check_names_) {
          auto nm = base_read_name(rec.head, rec.head_len);
          if (s.names.capacity() == 0) {
            // one up-front reservation instead of doubling through ~2MB of
            // packed names per chunk; sized from the first name seen
            s.names.reserve(static_cast<size_t>(n) * (nm.second + 2));
            s.name_end.reserve(static_cast<size_t>(n));
          }
          s.names.insert(s.names.end(), nm.first, nm.first + nm.second);
          s.name_end.push_back(static_cast<uint32_t>(s.names.size()));
        }
        const size_t sz = 1 + rec.head_len + 1 + rec.seq_len + 1 +
                          rec.plus_len + 1 + rec.qual_len + 1;
        if (sz < kBgzfBlockInput) {
          // single-copy emit straight into the BGZF block buffer (same
          // reserve/commit contract the demux route path uses)
          uint8_t* p = writers_[i]->reserve(sz);
          *p++ = '@';
          memcpy(p, rec.head, rec.head_len);
          p += rec.head_len;
          *p++ = '\n';
          memcpy(p, rec.seq, rec.seq_len);
          p += rec.seq_len;
          *p++ = '\n';
          memcpy(p, rec.plus, rec.plus_len);
          p += rec.plus_len;
          *p++ = '\n';
          memcpy(p, rec.qual, rec.qual_len);
          p += rec.qual_len;
          *p++ = '\n';
          writers_[i]->commit(sz);
        } else {
          // records larger than one BGZF block go through the splitting
          // write() path
          rec_buf.clear();
          rec_buf.push_back('@');
          rec_buf.insert(rec_buf.end(), rec.head, rec.head + rec.head_len);
          rec_buf.push_back('\n');
          rec_buf.insert(rec_buf.end(), rec.seq, rec.seq + rec.seq_len);
          rec_buf.push_back('\n');
          rec_buf.insert(rec_buf.end(), rec.plus, rec.plus + rec.plus_len);
          rec_buf.push_back('\n');
          rec_buf.insert(rec_buf.end(), rec.qual, rec.qual + rec.qual_len);
          rec_buf.push_back('\n');
          writers_[i]->write(rec_buf.data(), rec_buf.size());
        }
      }
      work_ns_ += thread_cpu_ns() - t0 -
                  (CompressorPool::tl_donated() - don0);
      s.end_wall = wall_ns();
    };
    std::vector<std::thread> ts;
    ts.reserve(n_in - 1);
    for (size_t i = 1; i < n_in; i++) ts.emplace_back(work, i);
    work(0);
    for (auto& t : ts) t.join();
    for (size_t i = 0; i < n_in; i++) {
      if (!st[i].error.empty()) {
        err.set(st[i].error);
        return -1;
      }
    }
    {
      // lockstep-skew accounting: core-seconds workers spent finished but
      // waiting at the per-chunk barrier for the slowest input (mostly
      // soaked by the nice+5 compressor pool, but reported so the residual
      // ceiling gap stays attributable)
      uint64_t max_end = 0;
      for (auto& s : st) max_end = std::max(max_end, s.end_wall);
      for (auto& s : st) skew_ns_ += max_end - s.end_wall;
    }
    int64_t consumed = st[0].consumed;
    int64_t min_c = consumed;
    for (size_t i = 1; i < n_in; i++)
      min_c = std::min(min_c, st[i].consumed);
    bool in_sync = true;
    for (size_t i = 0; i < n_in; i++) in_sync &= st[i].consumed == min_c;
    if (!in_sync) {
      size_t got = 0;
      for (auto& s : st) got += s.consumed > min_c ? 1 : 0;
      err.set(str_printf(
          "FASTQ files are out of sync: %zu of %zu files had a record at "
          "read %lld",
          got, n_in, static_cast<long long>(total_read_ + min_c + 1)));
      return -1;
    }
    if (check_names_) {
      const auto& f0 = st[0];
      for (size_t i = 1; i < n_in; i++) {
        const auto& fi = st[i];
        // happy path: every kept name matches <=> the packed buffers and
        // their offset tables are identical — two whole-buffer memcmps
        // instead of a per-record walk (the walk was ~the largest serial
        // cost between chunks; it now runs only to locate a mismatch)
        if (fi.name_end.size() == f0.name_end.size() &&
            fi.names.size() == f0.names.size() &&
            memcmp(f0.name_end.data(), fi.name_end.data(),
                   f0.name_end.size() * sizeof(uint32_t)) == 0 &&
            memcmp(f0.names.data(), fi.names.data(), f0.names.size()) == 0)
          continue;
        for (size_t r = 0; r < f0.name_end.size(); r++) {
          const uint32_t a0 = r ? f0.name_end[r - 1] : 0;
          const uint32_t a1 = f0.name_end[r];
          const uint32_t b0 = r ? fi.name_end[r - 1] : 0;
          const uint32_t b1 = fi.name_end[r];
          if (a1 - a0 == b1 - b0 &&
              memcmp(f0.names.data() + a0, fi.names.data() + b0, a1 - a0) ==
                  0)
            continue;
          // absolute row of the r-th kept record, for the read number
          int64_t row = 0, seen = -1;
          for (int64_t q = 0; q < consumed; q++) {
            if (keep_mask[q] && ++seen == static_cast<int64_t>(r)) {
              row = q;
              break;
            }
          }
          err.set(str_printf(
              "Read name mismatch at read %lld: file 0=\"%s\", file "
              "%zu=\"%s\"",
              static_cast<long long>(total_read_ + row + 1),
              std::string(f0.names.begin() + a0, f0.names.begin() + a1)
                  .c_str(),
              i,
              std::string(fi.names.begin() + b0, fi.names.begin() + b1)
                  .c_str()));
          return -1;
        }
      }
    }
    int64_t kept = 0;
    for (int64_t r = 0; r < consumed; r++) kept += keep_mask[r] ? 1 : 0;
    total_read_ += consumed;
    *kept_out = kept;
    return consumed;
  }

  bool finish() {
    for (auto& w : writers_) w->flush_final();
    for (auto& w : writers_) w->close();
    if (pool_) pool_->stop();
    return !err.failed;
  }

  // [work_s (inflate+scan+name-collect+record-copy thread-CPU, summed over
  //  worker threads), compress_s (pool busy), bytes_in, bytes_out,
  //  lockstep_skew_s (core-s finished workers waited at the chunk
  //  barrier)] — the subsample analog of the demux stage stats, for
  //  host-ceiling accounting
  void get_stats(double* out, int n) const {
    double vals[5] = {
        work_ns_.load() * 1e-9,
        pool_ ? pool_->busy_ns.load() * 1e-9 : 0.0,
        pool_ ? static_cast<double>(pool_->bytes_in.load()) : 0.0,
        pool_ ? static_cast<double>(pool_->bytes_out.load()) : 0.0,
        skew_ns_.load() * 1e-9,
    };
    for (int i = 0; i < n && i < 5; i++) out[i] = vals[i];
  }

 private:
  // NB: pool_ must be declared BEFORE writers_ so it is destroyed AFTER
  // them — BgzfWriter::close() submits its final block to the pool and
  // waits for delivery; a dead pool would deadlock it (hit on error paths
  // where finish() never runs).
  std::unique_ptr<CompressorPool> pool_;
  std::vector<std::unique_ptr<FastqScanner>> scanners_;
  std::vector<std::unique_ptr<BgzfWriter>> writers_;
  int level_ = 5;
  bool check_names_ = false;
  bool parallel_ = false;
  int64_t total_read_ = 0;
  std::atomic<uint64_t> work_ns_{0};
  std::atomic<uint64_t> skew_ns_{0};
};

// ---------------------------------------------------------------------------
// Big-K pigeonhole matcher (host fast path for huge whitelists).
//
// For a whitelist of K pure-ACGT barcodes (e.g. 737K single-cell barcodes),
// the brute-force [B, K] mismatch matrix is O(B*K*L) — wasteful even on a
// matrix unit.  Pigeonhole: any barcode within max_mm + max(delta,1) - 1 mismatches
// of a read must match at least one of max_mm + max(delta,1) disjoint parts
// EXACTLY, so candidates come from part-indexed exact-match tables (CSR over
// 2-bit-packed part values) and only candidates get a full mismatch count.
// Exactness argument for the delta gate: every barcode with
// mm <= max_mm + delta - 1 is a candidate, so the candidate-derived
// (best, next) decide accept/reject identically to the full scan (a
// non-candidate has mm >= max_mm + delta >= best + delta and can neither
// win nor violate the delta gate).  Ties replicate the reference's strict-<
// update (equal best counts toward next_best; lowest index wins best).
//
// Pure-ACGT whitelists take the fused/XOR fast paths below.  Whitelists
// with degenerate IUPAC codes build EXPANDED tables (each barcode inserted
// under every part key its masks accept — exact-match hashing on raw
// values would be unsound for them) and score candidates with 4-bit-mask
// containment; see build_iupac/assign_one_iupac.  Observed bytes
// canonicalize through the IUPAC mask (U == T; against a pure-ACGT
// whitelist any multi-bit/no-call mask always mismatches, so parts holding
// one are skipped there; mask-0 bytes — invalid characters like 'X' — are
// spec-level wildcards and get key enumeration, see assign_one).
// ---------------------------------------------------------------------------

// --- fused bucket-scan kernels (BigKMatcher hot loop, len <= 16) ----------
//
// The filter streams a pack-only uint32 array — 4 sequential bytes per
// candidate — and a branch-free SIMD pass: XOR vs the packed observation,
// fold bit pairs, per-lane popcount (nibble shuffle + maddubs/madd lane
// sums), compare against the mismatch cap.  Candidates almost always fail
// the cap (random barcodes differ in ~3/4 of positions), so survivors are
// rare and only they touch the parallel id array.  At production K the
// scan is memory-bandwidth-bound, so halving bytes/candidate (vs the
// earlier (id << 32) | packed2 u64 entries) is a direct speedup, and each
// 256/512-bit load now filters 8/16 candidates instead of 4/8.

inline void top2_update(int mm, int64_t id, int& best, int& next,
                        int64_t& best_id) {
  if (mm < best) {
    next = best;
    best = mm;
    best_id = id;
  } else if (mm == best) {
    // duplicate candidates (same barcode exact in several parts) must not
    // count as their own runner-up; ties keep the lower index
    if (id == best_id) return;
    next = best;
    best_id = std::min(best_id, id);
  } else if (mm < next) {
    next = mm;
  }
}

// len <= 16: a 2-bit-packed barcode fits in 32 bits, so the filter streams
// a pack-only uint32 array (4 bytes per candidate — the scan is memory-
// bandwidth-bound at production K, so bytes ARE time) and the parallel id
// array is touched only for the rare cap survivors.
using FusedScanFn = void (*)(const uint32_t*, const uint32_t*, uint32_t,
                             uint32_t, uint32_t, uint32_t, int, int&, int&,
                             int64_t&);

void fused_scan_scalar(const uint32_t* packs, const uint32_t* ids,
                       uint32_t lo, uint32_t hi, uint32_t obs2,
                       uint32_t low_mask, int cap, int& best, int& next,
                       int64_t& best_id) {
  for (uint32_t i = lo; i < hi; i++) {
    const uint32_t x = (packs[i] ^ obs2) & low_mask;
    const uint32_t y = (x | (x >> 1)) & 0x55555555u;
    const int mm = __builtin_popcount(y);
    if (mm > cap) continue;
    top2_update(mm, static_cast<int64_t>(ids[i]), best, next, best_id);
  }
}

#ifdef FQTK_X86_SIMD

// GCC's avx512 intrinsic headers trip -Wmaybe-uninitialized (the
// _mm512_undefined_* helpers behind broadcast); not our code.
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wuninitialized"
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"

__attribute__((target("avx2"))) void fused_scan_avx2(
    const uint32_t* packs, const uint32_t* ids, uint32_t lo, uint32_t hi,
    uint32_t obs2, uint32_t low_mask, int cap, int& best, int& next,
    int64_t& best_id) {
  const __m256i obs = _mm256_set1_epi32(static_cast<int>(obs2));
  const __m256i lowm = _mm256_set1_epi32(static_cast<int>(low_mask));
  const __m256i fives = _mm256_set1_epi32(0x55555555);
  const __m256i nib = _mm256_set1_epi8(0x0f);
  const __m256i lut = _mm256_broadcastsi128_si256(
      _mm_setr_epi8(0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4));
  const __m256i capv = _mm256_set1_epi32(cap);
  const __m256i ones8 = _mm256_set1_epi8(1);
  const __m256i ones16 = _mm256_set1_epi16(1);
  uint32_t i = lo;
  for (; i + 8 <= hi; i += 8) {
    __m256i e =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(packs + i));
    __m256i x = _mm256_and_si256(_mm256_xor_si256(e, obs), lowm);
    __m256i y =
        _mm256_and_si256(_mm256_or_si256(x, _mm256_srli_epi32(x, 1)), fives);
    __m256i cl = _mm256_shuffle_epi8(lut, _mm256_and_si256(y, nib));
    __m256i ch = _mm256_shuffle_epi8(
        lut, _mm256_and_si256(_mm256_srli_epi16(y, 4), nib));
    // per-32-bit-lane byte sums: maddubs(bytes, 1) -> 16-bit pairs,
    // madd(pairs, 1) -> lane totals (all values tiny, no overflow)
    __m256i sums = _mm256_madd_epi16(
        _mm256_maddubs_epi16(_mm256_add_epi8(cl, ch), ones8), ones16);
    int fail = _mm256_movemask_ps(
        _mm256_castsi256_ps(_mm256_cmpgt_epi32(sums, capv)));
    int pass = ~fail & 0xFF;
    while (pass) {
      const int b = __builtin_ctz(static_cast<unsigned>(pass));
      pass &= pass - 1;
      const uint32_t xx = (packs[i + b] ^ obs2) & low_mask;
      const int mm = __builtin_popcount((xx | (xx >> 1)) & 0x55555555u);
      top2_update(mm, static_cast<int64_t>(ids[i + b]), best, next, best_id);
    }
  }
  if (i < hi)
    fused_scan_scalar(packs, ids, i, hi, obs2, low_mask, cap, best, next,
                      best_id);
}

__attribute__((target("avx512f,avx512bw"))) void fused_scan_avx512(
    const uint32_t* packs, const uint32_t* ids, uint32_t lo, uint32_t hi,
    uint32_t obs2, uint32_t low_mask, int cap, int& best, int& next,
    int64_t& best_id) {
  const __m512i obs = _mm512_set1_epi32(static_cast<int>(obs2));
  const __m512i lowm = _mm512_set1_epi32(static_cast<int>(low_mask));
  const __m512i fives = _mm512_set1_epi32(0x55555555);
  const __m512i nib = _mm512_set1_epi8(0x0f);
  const __m512i lut = _mm512_broadcast_i32x4(
      _mm_setr_epi8(0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4));
  const __m512i capv = _mm512_set1_epi32(cap);
  const __m512i ones8 = _mm512_set1_epi8(1);
  const __m512i ones16 = _mm512_set1_epi16(1);
  uint32_t i = lo;
  for (; i + 16 <= hi; i += 16) {
    __m512i e = _mm512_loadu_si512(packs + i);
    __m512i x = _mm512_and_si512(_mm512_xor_si512(e, obs), lowm);
    __m512i y =
        _mm512_and_si512(_mm512_or_si512(x, _mm512_srli_epi32(x, 1)), fives);
    __m512i cl = _mm512_shuffle_epi8(lut, _mm512_and_si512(y, nib));
    __m512i ch = _mm512_shuffle_epi8(
        lut, _mm512_and_si512(_mm512_srli_epi16(y, 4), nib));
    __m512i sums = _mm512_madd_epi16(
        _mm512_maddubs_epi16(_mm512_add_epi8(cl, ch), ones8), ones16);
    unsigned pass = _mm512_cmple_epu32_mask(sums, capv);
    while (pass) {
      const int b = __builtin_ctz(pass);
      pass &= pass - 1;
      const uint32_t xx = (packs[i + b] ^ obs2) & low_mask;
      const int mm = __builtin_popcount((xx | (xx >> 1)) & 0x55555555u);
      top2_update(mm, static_cast<int64_t>(ids[i + b]), best, next, best_id);
    }
  }
  if (i < hi)
    fused_scan_scalar(packs, ids, i, hi, obs2, low_mask, cap, best, next,
                      best_id);
}

#pragma GCC diagnostic pop

#endif  // FQTK_X86_SIMD

// FQTK_SIMD=scalar|avx2|avx512 caps the dispatch level (default: best the
// CPU supports).  Tests use it to exercise every variant on one host — an
// avx512 machine otherwise never runs the avx2 code at all.
inline int simd_level_cap() {
  const char* e = getenv("FQTK_SIMD");
  if (!e) return 2;
  if (strcmp(e, "scalar") == 0) return 0;
  if (strcmp(e, "avx2") == 0) return 1;
  if (strcmp(e, "avx512") != 0)
    fprintf(stderr,
            "fqtk: WARNING: unrecognized FQTK_SIMD=%s (expected "
            "scalar|avx2|avx512); using best available\n",
            e);
  return 2;
}

FusedScanFn pick_fused_scan() {
#ifdef FQTK_X86_SIMD
  const int cap = simd_level_cap();
  if (cap >= 2 && __builtin_cpu_supports("avx512bw")) return fused_scan_avx512;
  if (cap >= 1 && __builtin_cpu_supports("avx2")) return fused_scan_avx2;
#endif
  return fused_scan_scalar;
}

// Degenerate-whitelist (4-bit mask) candidate scan: mismatch iff any
// observed bit falls outside the expected mask (bitenc.rs:441), i.e.
// popcount of the nibble-collapsed obs & ~exp.  Same filter-then-rescore
// shape as the fused 2-bit scan above; `ids` may be null (candidate id ==
// element index, the full-scan case).
using IupacScanFn = void (*)(const uint64_t*, const uint32_t*, uint32_t,
                             uint32_t, uint64_t, int, int&, int&, int64_t&);

// exact mismatch count for one candidate (the scalar rescore the SIMD
// filters hand survivors to)
static inline int iupac_mm(uint64_t obs4, uint64_t exp4) {
  uint64_t t = obs4 & ~exp4;
  uint64_t y = t | (t >> 1);
  y = (y | (y >> 2)) & 0x1111111111111111ull;
  return __builtin_popcountll(y);
}

void iupac_scan_scalar(const uint64_t* packs, const uint32_t* ids,
                       uint32_t lo, uint32_t hi, uint64_t obs4, int cap,
                       int& best, int& next, int64_t& best_id) {
  for (uint32_t i = lo; i < hi; i++) {
    const int mm = iupac_mm(obs4, packs[i]);
    if (mm > cap) continue;
    top2_update(mm,
                ids ? static_cast<int64_t>(ids[i]) : static_cast<int64_t>(i),
                best, next, best_id);
  }
}

#ifdef FQTK_X86_SIMD

#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wuninitialized"
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"

__attribute__((target("avx2"))) void iupac_scan_avx2(
    const uint64_t* packs, const uint32_t* ids, uint32_t lo, uint32_t hi,
    uint64_t obs4, int cap, int& best, int& next, int64_t& best_id) {
  const __m256i obs = _mm256_set1_epi64x(static_cast<long long>(obs4));
  const __m256i ones = _mm256_set1_epi64x(0x1111111111111111LL);
  const __m256i nib = _mm256_set1_epi8(0x0f);
  const __m256i lut = _mm256_broadcastsi128_si256(
      _mm_setr_epi8(0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4));
  const __m256i capv = _mm256_set1_epi64x(cap);
  const __m256i zero = _mm256_setzero_si256();
  uint32_t i = lo;
  for (; i + 4 <= hi; i += 4) {
    __m256i e =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(packs + i));
    __m256i t = _mm256_andnot_si256(e, obs);  // obs & ~exp
    __m256i y = _mm256_or_si256(t, _mm256_srli_epi64(t, 1));
    y = _mm256_and_si256(_mm256_or_si256(y, _mm256_srli_epi64(y, 2)), ones);
    __m256i cl = _mm256_shuffle_epi8(lut, _mm256_and_si256(y, nib));
    __m256i ch = _mm256_shuffle_epi8(
        lut, _mm256_and_si256(_mm256_srli_epi16(y, 4), nib));
    __m256i sums = _mm256_sad_epu8(_mm256_add_epi8(cl, ch), zero);
    int fail = _mm256_movemask_pd(
        _mm256_castsi256_pd(_mm256_cmpgt_epi64(sums, capv)));
    int pass = ~fail & 0xF;
    while (pass) {
      const int b = __builtin_ctz(static_cast<unsigned>(pass));
      pass &= pass - 1;
      top2_update(iupac_mm(obs4, packs[i + b]),
                  ids ? static_cast<int64_t>(ids[i + b])
                      : static_cast<int64_t>(i + b),
                  best, next, best_id);
    }
  }
  if (i < hi)
    iupac_scan_scalar(packs, ids, i, hi, obs4, cap, best, next, best_id);
}

__attribute__((target("avx512f,avx512bw"))) void iupac_scan_avx512(
    const uint64_t* packs, const uint32_t* ids, uint32_t lo, uint32_t hi,
    uint64_t obs4, int cap, int& best, int& next, int64_t& best_id) {
  const __m512i obs = _mm512_set1_epi64(static_cast<long long>(obs4));
  const __m512i ones = _mm512_set1_epi64(0x1111111111111111LL);
  const __m512i nib = _mm512_set1_epi8(0x0f);
  const __m512i lut = _mm512_broadcast_i32x4(
      _mm_setr_epi8(0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4));
  const __m512i capv = _mm512_set1_epi64(cap);
  uint32_t i = lo;
  for (; i + 8 <= hi; i += 8) {
    __m512i e = _mm512_loadu_si512(packs + i);
    __m512i t = _mm512_andnot_si512(e, obs);  // obs & ~exp
    __m512i y = _mm512_or_si512(t, _mm512_srli_epi64(t, 1));
    y = _mm512_and_si512(_mm512_or_si512(y, _mm512_srli_epi64(y, 2)), ones);
    __m512i cl = _mm512_shuffle_epi8(lut, _mm512_and_si512(y, nib));
    __m512i ch = _mm512_shuffle_epi8(
        lut, _mm512_and_si512(_mm512_srli_epi16(y, 4), nib));
    __m512i sums = _mm512_sad_epu8(_mm512_add_epi8(cl, ch),
                                   _mm512_setzero_si512());
    unsigned pass = _mm512_cmple_epu64_mask(sums, capv);
    while (pass) {
      const int b = __builtin_ctz(pass);
      pass &= pass - 1;
      top2_update(iupac_mm(obs4, packs[i + b]),
                  ids ? static_cast<int64_t>(ids[i + b])
                      : static_cast<int64_t>(i + b),
                  best, next, best_id);
    }
  }
  if (i < hi)
    iupac_scan_scalar(packs, ids, i, hi, obs4, cap, best, next, best_id);
}

#pragma GCC diagnostic pop

#endif  // FQTK_X86_SIMD

IupacScanFn pick_iupac_scan() {
#ifdef FQTK_X86_SIMD
  const int cap = simd_level_cap();
  if (cap >= 2 && __builtin_cpu_supports("avx512bw")) return iupac_scan_avx512;
  if (cap >= 1 && __builtin_cpu_supports("avx2")) return iupac_scan_avx2;
#endif
  return iupac_scan_scalar;
}

// Direct-mapped memo cache shared by the host matchers (reference parity:
// the reference memoizes observed barcode bytes -> match in an AHashMap,
// barcode_matching.rs:173-182, because real reads cluster on few distinct
// barcode values).  One table per worker slot, no sharing, no locks; a
// collision simply overwrites — a miss only re-runs the scan.  Keys are
// the tail-masked packed observation (<= two u64s, i.e. barcode length
// <= 32 in the nib4 layout).  Caching unmatched outcomes too is
// semantically identical (the matchers are pure functions of the row).
struct MemoEntry {
  uint64_t k0, k1;
  int32_t v;
  uint32_t used;
};

static inline uint64_t memo_hash(uint64_t k0, uint64_t k1) {
  // splitmix64 finalizer over the combined key
  uint64_t h = k0 ^ (k1 * 0x9E3779B97F4A7C15ull);
  h ^= h >> 30;
  h *= 0xBF58476D1CE4E5B9ull;
  h ^= h >> 27;
  return h;
}

class BigKMatcher {
 public:
  // barcodes: K rows of len bytes, uppercase IUPAC (invalid bytes -> ok_
  // false).  Pure-ACGT whitelists take the fused/XOR fast paths; whitelists
  // with degenerate codes (N/R/Y/...) build expanded tables: each barcode
  // is inserted under EVERY part key it accepts (product of accepted bases
  // per position), candidates score with 4-bit-mask containment.  Barcodes
  // too degenerate to enumerate go on an always-candidate list scanned for
  // every read — correctness never depends on the expansion cap.
  BigKMatcher(const uint8_t* barcodes, int64_t k, int len, int max_mm,
              int delta)
      : k_(k), len_(len), max_mm_(max_mm), delta_(delta) {
    n_parts_ = max_mm + std::max(delta, 1);
    // eligibility: parts must fit the length, lengths must fit 64-bit
    // packing, and every part's key space must stay dense-table-sized
    // (ceil(len / n_parts) 2-bit symbols -> 4^part_len offsets; cap at
    // 4^12 = 16M keys).  Ineligible whitelists fall back to the device
    // paths via fqtk_bigk_new returning null.
    if (n_parts_ < 1 || n_parts_ > len || len > 32 ||
        (len + n_parts_ - 1) / n_parts_ > 12) {
      ok_ = false;
      return;
    }
    for (int64_t i = 0; i < k * len; i++) {
      uint8_t m = kIupac.encode[barcodes[i]];
      if (m == 0) {  // invalid whitelist byte (callers validate upstream)
        ok_ = false;
        return;
      }
      if (__builtin_popcount(m) != 1) iupac_ = true;
    }
    if (iupac_ && (len > 16 || k > static_cast<int64_t>(UINT32_MAX))) {
      ok_ = false;  // degenerate whitelists: single-u64 4-bit packing only
      return;
    }
    // memo-cache keys: the nib4 row tail-masked to 4*len bits (len <= 32
    // guaranteed by eligibility above)
    key_mask0_ = len >= 16 ? ~0ull : (~0ull >> (64 - 4 * len));
    key_mask1_ = len <= 16  ? 0ull
                 : len == 32 ? ~0ull
                              : (~0ull >> (128 - 4 * len));
    cache_enabled_ = getenv("FQTK_BIGK_NO_CACHE") == nullptr;
    // part boundaries: len split as evenly as possible
    int base = len / n_parts_, extra = len % n_parts_;
    int off = 0;
    for (int p = 0; p < n_parts_; p++) {
      int plen = base + (p < extra ? 1 : 0);
      part_off_.push_back(off);
      part_len_.push_back(plen);
      off += plen;
    }
    if (iupac_) {
      build_iupac(barcodes);
      return;
    }
    // len <= 16 (every real single-cell whitelist): packed barcode fits 32
    // bits, so bucket entries fuse (id << 32) | packed2 into one u64
    fused_ = len <= 16 && k <= static_cast<int64_t>(UINT32_MAX);
    low_mask_ = len == 32 ? ~0ull : ((1ull << (2 * len)) - 1);
    scan_ = pick_fused_scan();
    codes_.resize(k * len);
    packed2_.resize(k);
    for (int64_t s = 0; s < k; s++) {
      uint64_t packed = 0;
      for (int j = 0; j < len; j++) {
        int c = base_code2(barcodes[s * len + j]);
        codes_[s * len + j] = static_cast<uint8_t>(c);
        packed |= static_cast<uint64_t>(c) << (2 * j);
      }
      packed2_[s] = packed;
    }
    // CSR table per part: key = packed 2-bit part value -> barcode ids
    tables_.resize(n_parts_);
    for (int p = 0; p < n_parts_; p++) {
      auto& t = tables_[p];
      t.n_keys = 1u << (2 * part_len_[p]);
      t.offsets.assign(t.n_keys + 1, 0);
      std::vector<uint32_t> keys(k);
      for (int64_t s = 0; s < k; s++) {
        uint32_t key = 0;
        const uint8_t* c = codes_.data() + s * len_ + part_off_[p];
        for (int j = 0; j < part_len_[p]; j++) key = (key << 2) | c[j];
        keys[s] = key;
        t.offsets[key + 1]++;
      }
      for (size_t i = 1; i < t.offsets.size(); i++)
        t.offsets[i] += t.offsets[i - 1];
      std::vector<uint32_t> cursor(t.offsets.begin(), t.offsets.end() - 1);
      if (fused_) {
        // split arrays: the SIMD filter streams 4-byte packs only; ids are
        // random-accessed for the rare survivors (fused_scan_* above)
        t.packs32.resize(k);
        t.ids32.resize(k);
        for (int64_t s = 0; s < k; s++) {
          uint32_t slot = cursor[keys[s]]++;
          t.packs32[slot] = static_cast<uint32_t>(packed2_[s]);
          t.ids32[slot] = static_cast<uint32_t>(s);
        }
      } else {
        t.ids.resize(k);
        t.packs.resize(k);
        for (int64_t s = 0; s < k; s++) {
          uint32_t slot = cursor[keys[s]]++;
          t.ids[slot] = static_cast<uint32_t>(s);
          // inline the packed barcode: candidate loads stream sequentially
          // through the bucket instead of random-accessing packed2_
          t.packs[slot] = packed2_[s];
        }
      }
    }
  }

  // Expansion bound for degenerate-whitelist table construction: a barcode
  // whose accepted-key products exceed this (across all parts) is scanned
  // for every read instead of being table-indexed.  One expected 'N' costs
  // 4 entries in its part; the cap admits several per barcode.
  static constexpr int kMaxExpPerBarcode = 64;

  void build_iupac(const uint8_t* barcodes) {
    // scoring uses only packed4_/t.packs, so the [K, L] mask matrix is a
    // build-time local (at K=737K it would otherwise retain ~12MB for life)
    std::vector<uint8_t> exp_masks(static_cast<size_t>(k_) * len_);
    packed4_.resize(k_);
    max_ns_ = 0;
    std::vector<uint8_t> always(k_, 0);
    for (int64_t s = 0; s < k_; s++) {
      uint64_t p4 = 0;
      int ns = 0;
      for (int j = 0; j < len_; j++) {
        uint8_t b = barcodes[s * len_ + j];
        uint8_t m = kIupac.encode[b];
        exp_masks[s * len_ + j] = m;
        p4 |= static_cast<uint64_t>(m) << (4 * j);
        // no-call budget counts every no-call spelling (N/n/.), matching
        // the spec's NOCALL_LUT (mod.rs:85-87), not just literal 'N'
        ns += kIupac.nocall[b];
      }
      packed4_[s] = p4;
      max_ns_ = std::max(max_ns_, ns);
      // total enumerated entries this barcode would add across parts
      int64_t total = 0;
      for (int p = 0; p < n_parts_ && !always[s]; p++) {
        int64_t prod = 1;
        for (int j = 0; j < part_len_[p]; j++)
          prod *= __builtin_popcount(exp_masks[s * len_ + part_off_[p] + j]);
        total += prod;
        if (prod > kMaxExpPerBarcode || total > kMaxExpPerBarcode)
          always[s] = 1;
      }
      if (always[s]) {
        always_candidates_.push_back(static_cast<uint32_t>(s));
        always_packs_.push_back(p4);  // contiguous packs: SIMD-scannable
      }
    }
    iscan_ = pick_iupac_scan();
    tables_.resize(n_parts_);
    for (int p = 0; p < n_parts_; p++) {
      auto& t = tables_[p];
      t.n_keys = 1u << (2 * part_len_[p]);
      t.offsets.assign(t.n_keys + 1, 0);
      for (int64_t s = 0; s < k_; s++) {
        if (always[s]) continue;
        enum_part_keys(exp_masks.data() + s * len_ + part_off_[p],
                       part_len_[p],
                       [&](uint32_t key) { t.offsets[key + 1]++; });
      }
      for (size_t i = 1; i < t.offsets.size(); i++)
        t.offsets[i] += t.offsets[i - 1];
      std::vector<uint32_t> cursor(t.offsets.begin(), t.offsets.end() - 1);
      t.ids.resize(t.offsets.back());
      t.packs.resize(t.offsets.back());
      for (int64_t s = 0; s < k_; s++) {
        if (always[s]) continue;
        enum_part_keys(exp_masks.data() + s * len_ + part_off_[p],
                       part_len_[p], [&](uint32_t key) {
                         uint32_t slot = cursor[key]++;
                         t.ids[slot] = static_cast<uint32_t>(s);
                         t.packs[slot] = packed4_[s];
                       });
      }
    }
  }

  // Enumerate every part key whose per-position base is accepted by the
  // part's masks (odometer over the set bits of each mask).
  template <typename F>
  static void enum_part_keys(const uint8_t* pm, int plen, F&& fn) {
    uint8_t bases[12][4];
    int nb[12], idx[12];
    for (int j = 0; j < plen; j++) {
      nb[j] = 0;
      idx[j] = 0;
      for (int b = 0; b < 4; b++)
        if ((pm[j] >> b) & 1) bases[j][nb[j]++] = static_cast<uint8_t>(b);
    }
    for (;;) {
      uint32_t key = 0;
      for (int j = 0; j < plen; j++)
        key = (key << 2) | bases[j][idx[j]];
      fn(key);
      int j = plen - 1;
      while (j >= 0 && ++idx[j] == nb[j]) idx[j--] = 0;
      if (j < 0) break;
    }
  }

  bool ok() const { return ok_; }


  // obs: packed 4-bit IUPAC masks, 2 per byte (the pipeline's device
  // layout); row r at obs + r*stride.  Writes assigned[r] in [0, k] (k =
  // unmatched).  Parallelized over rows.
  // Memo-cache table size: single-cell reads repeat their cell barcode
  // thousands of times, so ~256K slots comfortably hold the distinct
  // observed values of real datasets (cells + low-order mutants).
  static constexpr int kCacheBits = 18;

  void assign_batch(const uint8_t* obs, int64_t n, int64_t stride,
                    int32_t* assigned, int n_threads) {
    // the cache makes the matcher stateful (the reference's cached assign
    // takes &mut self): external concurrent calls on ONE matcher serialize
    // here; the per-call worker threads below still parallelize the batch
    std::lock_guard<std::mutex> lock(assign_mu_);
    n_threads = std::max(1, n_threads);
    const bool use_cache = cache_enabled_;
    if (use_cache && static_cast<int>(caches_.size()) < n_threads)
      caches_.resize(n_threads);
    const int row_bytes = (len_ + 1) / 2;
    auto work = [this, obs, stride, assigned, use_cache, row_bytes](
                    int t, int64_t lo, int64_t hi) {
      MemoEntry* cache = nullptr;
      if (use_cache) {
        if (caches_[t].empty()) caches_[t].assign(1u << kCacheBits, {});
        cache = caches_[t].data();
      }
      for (int64_t r = lo; r < hi; r++) {
        const uint8_t* row = obs + r * stride;
        if (!cache) {
          assigned[r] = assign_one(row);
          continue;
        }
        uint64_t kb[2] = {0, 0};
        memcpy(kb, row, row_bytes);
        kb[0] &= key_mask0_;
        kb[1] &= key_mask1_;
        MemoEntry* slot =
            cache + (memo_hash(kb[0], kb[1]) & ((1u << kCacheBits) - 1));
        if (slot->used && slot->k0 == kb[0] && slot->k1 == kb[1]) {
          assigned[r] = slot->v;
          continue;
        }
        const int32_t v = assign_one(row);
        slot->k0 = kb[0];
        slot->k1 = kb[1];
        slot->v = v;
        slot->used = 1;
        assigned[r] = v;
      }
    };
    std::vector<std::thread> ts;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t + 1 < n_threads; t++) {
      int64_t lo = t * per, hi = std::min(n, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, t, lo, hi);
    }
    {
      // last partition on the calling thread: one fewer spawn/join
      int64_t lo = static_cast<int64_t>(n_threads - 1) * per;
      if (lo < n) work(n_threads - 1, lo, n);
    }
    for (auto& th : ts) th.join();
  }

  // Duplicate candidates (a barcode exact-matching several parts) are
  // PROVABLY harmless without dedup except when the duplicate is the
  // current best (its re-arrival with mm == best would count itself as its
  // own runner-up): the first processing establishes best <= mm and
  // next <= mm, and all update paths use strict <, so re-arrivals cannot
  // update anything — except the mm == best path, guarded by the id check.
  // This removes the visited-stamp array (a [K] random-access cache killer).
  //
  // Observed-byte semantics (must match the NumPy spec / reference encode):
  //   single-bit mask (A/C/G/T/U)  -> key digit; exact-match candidates
  //   multi-bit mask (IUPAC, N=15) -> ALWAYS mismatches a pure-ACGT
  //     whitelist position, so a part containing one can never zero-match:
  //     skipping that part is sound
  //   mask 0 (invalid byte, e.g. 'X') -> obs & ~exp == 0 for EVERY expected
  //     mask: a spec-level wildcard that never mismatches.  A part
  //     containing wildcards stays eligible: enumerate all 4^w keys that
  //     agree on the fixed digits (each candidate barcode sits under
  //     exactly one of them).  Reads whose wildcards would blow up the
  //     enumeration (> kMaxWildPerPart in one part) take a full whitelist
  //     scan instead — correct for adversarial input, never hit by real
  //     FASTQ.
  static constexpr int kMaxWildPerPart = 6;  // 4^6 = 4096 buckets max

  // Degenerate-whitelist variant of assign_one: same part-key walk, but
  // candidate buckets hold expanded insertions (see build_iupac) and score
  // with mask containment.  Key digit per position: single-bit/multi-bit
  // observed mask -> its lowest accepted base (a zero-mismatch expected
  // mask accepts every observed base, so its insertions cover that digit);
  // mask 0 (wildcard) -> enumerate all four.  The always-candidate list is
  // scanned unconditionally.
  int32_t assign_one_iupac(const uint8_t* row) {
    uint8_t masks[16];
    int nocalls = 0;
    uint64_t obs4 = 0;
    for (int j = 0; j < len_; j++) {
      uint8_t m = (j & 1) ? (row[j >> 1] >> 4) : (row[j >> 1] & 0xF);
      masks[j] = m;
      nocalls += (m == 15);
      obs4 |= static_cast<uint64_t>(m) << (4 * j);
    }
    if (nocalls > max_mm_ + max_ns_) return static_cast<int32_t>(k_);

    const int cap = max_mm_ + std::max(delta_, 1);
    int best = 256, next = 256;
    int64_t best_id = k_;
    bool full_scan = false;
    iscan_(always_packs_.data(), always_candidates_.data(), 0,
           static_cast<uint32_t>(always_candidates_.size()), obs4, cap, best,
           next, best_id);
    for (int p = 0; p < n_parts_ && !full_scan; p++) {
      uint32_t base_key = 0;
      int wshift[kMaxWildPerPart];
      int nw = 0;
      const int off = part_off_[p], plen = part_len_[p];
      for (int j = 0; j < plen; j++) {
        uint8_t m = masks[off + j];
        base_key <<= 2;
        if (m != 0) {
          base_key |= static_cast<uint32_t>(__builtin_ctz(m) & 3);
        } else {
          if (nw == kMaxWildPerPart) {
            full_scan = true;
            break;
          }
          wshift[nw++] = 2 * (plen - 1 - j);
        }
      }
      if (full_scan) break;
      const auto& t = tables_[p];
      const uint32_t n_combo = 1u << (2 * nw);
      for (uint32_t combo = 0; combo < n_combo; combo++) {
        uint32_t key = base_key;
        for (int i = 0; i < nw; i++)
          key |= ((combo >> (2 * i)) & 3u) << wshift[i];
        iscan_(t.packs.data(), t.ids.data(), t.offsets[key],
               t.offsets[key + 1], obs4, cap, best, next, best_id);
      }
    }
    if (full_scan) {
      best = 256;
      next = 256;
      best_id = k_;
      iscan_(packed4_.data(), nullptr, 0, static_cast<uint32_t>(k_), obs4,
             cap, best, next, best_id);
    }
    if (best > max_mm_) return static_cast<int32_t>(k_);
    if (next - best < delta_) return static_cast<int32_t>(k_);
    return static_cast<int32_t>(best_id);
  }

  int32_t assign_one(const uint8_t* row) {
    if (iupac_) return assign_one_iupac(row);
    // unpack nibbles -> masks; canonical 2-bit codes (or -1/-2) + no-calls
    uint8_t masks[32];
    int8_t codes[32];
    int nocalls = 0;
    bool pure = true;
    bool full_scan = false;
    uint64_t obs2 = 0;  // 2-bit packed observed codes (valid when pure)
    for (int j = 0; j < len_; j++) {
      uint8_t m = (j & 1) ? (row[j >> 1] >> 4) : (row[j >> 1] & 0xF);
      masks[j] = m;
      nocalls += (m == 15);
      int8_t c;
      switch (m) {
        case 1: c = 0; break;
        case 2: c = 1; break;
        case 4: c = 2; break;
        case 8: c = 3; break;
        case 0: c = -2; pure = false; break;  // wildcard (see above)
        default: c = -1; pure = false; break;
      }
      codes[j] = c;
      if (c >= 0) obs2 |= static_cast<uint64_t>(c) << (2 * j);
    }
    // no-call prefilter (max_ns_in_barcodes == 0: whitelist is pure ACGT)
    if (nocalls > max_mm_) return static_cast<int32_t>(k_);

    const int cap = max_mm_ + std::max(delta_, 1);  // counts >= cap are moot
    int best = 256, next = 256;
    int64_t best_id = k_;
    for (int p = 0; p < n_parts_ && !full_scan; p++) {
      uint32_t base_key = 0;
      bool eligible = true;
      int wshift[kMaxWildPerPart];  // key shift of each wildcard digit
      int nw = 0;
      const int off = part_off_[p], plen = part_len_[p];
      for (int j = 0; j < plen && eligible; j++) {
        int8_t c = codes[off + j];
        base_key <<= 2;
        if (c >= 0) {
          base_key |= static_cast<uint32_t>(c);
        } else if (c == -2) {
          if (nw == kMaxWildPerPart) {
            full_scan = true;
            break;
          }
          wshift[nw++] = 2 * (plen - 1 - j);
        } else {
          eligible = false;
        }
      }
      if (!eligible || full_scan) continue;
      const auto& t = tables_[p];
      const uint32_t n_combo = 1u << (2 * nw);
      for (uint32_t combo = 0; combo < n_combo; combo++) {
        uint32_t key = base_key;
        for (int i = 0; i < nw; i++)
          key |= ((combo >> (2 * i)) & 3u) << wshift[i];
        const uint32_t lo = t.offsets[key], hi = t.offsets[key + 1];
        if (pure && fused_) {
          // hot path: pack-only stream + SIMD filter (fused_scan_* above)
          scan_(t.packs32.data(), t.ids32.data(), lo, hi,
                static_cast<uint32_t>(obs2),
                static_cast<uint32_t>(low_mask_), cap, best, next, best_id);
        } else if (pure) {
          // 17..32bp whitelists: XOR of 2-bit-packed codes; a position
          // mismatches iff either of its 2 bits differs -> fold, popcount
          for (uint32_t i = lo; i < hi; i++) {
            const uint32_t id = t.ids[i];
            const uint64_t x = obs2 ^ t.packs[i];
            const uint64_t y = (x | (x >> 1)) & 0x5555555555555555ull;
            const int mm = __builtin_popcountll(y);
            if (mm > cap) continue;
            top2_update(mm, id, best, next, best_id);
          }
        } else {
          // rare path (IUPAC/no-call/wildcard bytes): per-position masks
          for (uint32_t i = lo; i < hi; i++) {
            const uint32_t id = fused_ ? t.ids32[i] : t.ids[i];
            const uint8_t* exp =
                codes_.data() + static_cast<int64_t>(id) * len_;
            int mm = 0;
            for (int j = 0; j < len_ && mm <= cap; j++)
              mm += (masks[j] & ~(1u << exp[j])) != 0;
            if (mm > cap) continue;
            top2_update(mm, id, best, next, best_id);
          }
        }
      }
    }
    if (full_scan) {
      // adversarial wildcard storm: score every barcode via the mask path
      best = 256;
      next = 256;
      best_id = k_;
      for (int64_t id = 0; id < k_; id++) {
        const uint8_t* exp = codes_.data() + id * len_;
        int mm = 0;
        for (int j = 0; j < len_ && mm <= cap; j++)
          mm += (masks[j] & ~(1u << exp[j])) != 0;
        if (mm > cap) continue;
        top2_update(mm, id, best, next, best_id);
      }
    }
    if (best > max_mm_) return static_cast<int32_t>(k_);
    if (next - best < delta_) return static_cast<int32_t>(k_);
    return static_cast<int32_t>(best_id);
  }

 private:
  struct CsrTable {
    uint32_t n_keys = 0;
    std::vector<uint32_t> offsets;
    std::vector<uint32_t> packs32;  // len <= 16: 2-bit packs, filter stream
    std::vector<uint32_t> ids32;    // len <= 16: ids, survivor lookups only
    std::vector<uint32_t> ids;      // len > 16 layout
    std::vector<uint64_t> packs;    // packed2_ of ids, bucket-ordered
  };
  int64_t k_;
  int len_, max_mm_, delta_, n_parts_ = 0;
  bool ok_ = true;
  bool fused_ = false;
  bool iupac_ = false;  // degenerate whitelist: expanded tables + mask scans
  int max_ns_ = 0;      // max 'N' count in any barcode (no-call budget)
  uint64_t low_mask_ = 0;
  FusedScanFn scan_ = fused_scan_scalar;
  std::vector<uint8_t> codes_;    // [K, L] 2-bit codes (pure mode)
  std::vector<uint64_t> packed2_; // [K] 2-bit-packed codes (hot-path XOR)
  std::vector<uint64_t> packed4_;    // [K] 4-bit-packed masks (iupac mode)
  std::vector<uint32_t> always_candidates_;  // too degenerate to enumerate
  std::vector<uint64_t> always_packs_;       // their packed4, contiguous
  IupacScanFn iscan_ = iupac_scan_scalar;
  std::vector<int> part_off_, part_len_;
  std::vector<CsrTable> tables_;
  bool cache_enabled_ = false;
  uint64_t key_mask0_ = 0, key_mask1_ = 0;  // tail masks for the memo key
  std::vector<std::vector<MemoEntry>> caches_;  // one per worker slot
  std::mutex assign_mu_;  // cache state: one batch at a time per matcher
};

// ---------------------------------------------------------------------------
// Small-K host matcher: brute-force scan over nibble-mask-packed barcodes.
//
// Placement context: when the whitelist is small, the per-batch device
// round-trip (dispatch latency + host<->device transfer) can exceed the entire
// brute-force host cost (K*L nibble-ops per read).  The demux auto policy
// (runtime/demux.py) routes such configurations here instead of stalling the
// pipeline on the device leg; the device paths remain the production route
// for every larger configuration.  Full IUPAC containment semantics
// (reference barcode_matching.rs:119-159 + bitenc.rs:432-459): a position
// mismatches iff observed_mask & ~expected_mask != 0, evaluated 16
// bases-per-u64 via nibble folding + popcount.  Unlike BigKMatcher this
// path accepts IUPAC-ambiguous whitelists (e.g. N-containing expected
// barcodes) — the masks carry the ambiguity natively.
// ---------------------------------------------------------------------------

class SmallKMatcher {
 public:
  static constexpr int kMaxBlocks = 16;  // 16 nibbles per u64 -> len <= 256

  // barcodes: K rows of len bytes, uppercase IUPAC (caller-validated)
  SmallKMatcher(const uint8_t* barcodes, int64_t k, int len, int max_mm,
                int delta)
      : k_(k), len_(len), max_mm_(max_mm), delta_(delta) {
    n_blocks_ = (len + 15) / 16;
    if (k < 1 || len < 1 || n_blocks_ > kMaxBlocks) {
      ok_ = false;
      return;
    }
    exp_.assign(static_cast<size_t>(k) * n_blocks_, 0);
    int max_ns = 0;
    for (int64_t s = 0; s < k; s++) {
      int ns = 0;
      for (int j = 0; j < len; j++) {
        uint8_t b = barcodes[s * len + j];
        uint8_t m = kIupac.encode[b];
        if (m == 0) {  // not a valid IUPAC byte
          ok_ = false;
          return;
        }
        ns += kIupac.nocall[b];
        exp_[s * n_blocks_ + (j >> 4)] |= static_cast<uint64_t>(m)
                                          << (4 * (j & 15));
      }
      max_ns = std::max(max_ns, ns);
    }
    // reference no-call prefilter budget (barcode_matching.rs:170-172)
    nocall_budget_ = max_mm + max_ns;
    int tail = len & 15;
    tail_mask_ = tail ? (~0ull >> (64 - 4 * tail)) : ~0ull;
    cache_enabled_ =
        n_blocks_ <= 2 && getenv("FQTK_SMALLK_NO_CACHE") == nullptr;
  }

  bool ok() const { return ok_; }

  // Memo cache (see MemoEntry above): engaged for len <= 32 (key fits two
  // u64s), which covers every realistic sample-barcode length.  ~64K slots
  // comfortably hold a small whitelist's distinct observed values.
  static constexpr int kCacheBits = 16;

  // obs: packed 4-bit IUPAC masks, 2 per byte (the pipeline's nib4 layout);
  // row r at obs + r*stride.  Writes assigned[r] in [0, k] (k = unmatched).
  void assign_batch(const uint8_t* obs, int64_t n, int64_t stride,
                    int32_t* assigned, int n_threads) {
    // The memo cache makes the matcher stateful (the reference's cached
    // BarcodeMatcher::assign takes &mut self for the same reason), so
    // external concurrent calls on ONE matcher serialize here; the
    // per-call worker threads below still parallelize the batch.
    std::lock_guard<std::mutex> lock(assign_mu_);
    n_threads = std::max(1, n_threads);
    const bool use_cache = cache_enabled_;
    // Adaptive width: when the previous batch was nearly all cache hits the
    // per-row work is a ~15ns probe, and thread spawn/scheduling costs more
    // than it saves (measured: 2 threads beat 7 by ~2x on warm 16K windows;
    // cache-off scans still want every core).  Real demux streams repeat
    // their barcodes heavily, so steady-state windows take the narrow path.
    int eff = n_threads;
    if (use_cache && last_batch_hot_) eff = std::min(n_threads, 2);
    if (use_cache && static_cast<int>(caches_.size()) < eff)
      caches_.resize(eff);
    std::atomic<int64_t> hits{0};
    auto work = [&](int t, int64_t lo, int64_t hi) {
      MemoEntry* cache = nullptr;
      if (use_cache) {
        if (caches_[t].empty()) caches_[t].assign(1u << kCacheBits, {});
        cache = caches_[t].data();
      }
      int64_t local_hits = 0;
      for (int64_t r = lo; r < hi; r++)
        assigned[r] = assign_one(obs + r * stride, cache, &local_hits);
      if (use_cache) hits.fetch_add(local_hits, std::memory_order_relaxed);
    };
    std::vector<std::thread> ts;
    int64_t per = (n + eff - 1) / eff;
    for (int t = 0; t + 1 < eff; t++) {
      int64_t lo = t * per, hi = std::min(n, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, t, lo, hi);
    }
    {
      // last partition runs on the calling thread: one fewer spawn/join
      int64_t lo = static_cast<int64_t>(eff - 1) * per;
      if (lo < n) work(eff - 1, lo, n);
    }
    for (auto& th : ts) th.join();
    if (use_cache && n > 0)
      last_batch_hot_ = hits.load(std::memory_order_relaxed) * 10 >= n * 9;
  }

  int32_t assign_one(const uint8_t* row, MemoEntry* cache = nullptr,
                     int64_t* hit_count = nullptr) {
    constexpr uint64_t kLow = 0x1111111111111111ull;
    uint64_t obs[kMaxBlocks];
    const int row_bytes = (len_ + 1) / 2;
    memcpy(obs, row, row_bytes);
    if (row_bytes < n_blocks_ * 8)
      memset(reinterpret_cast<uint8_t*>(obs) + row_bytes, 0,
             n_blocks_ * 8 - row_bytes);
    obs[n_blocks_ - 1] &= tail_mask_;
    MemoEntry* slot = nullptr;
    if (cache) {
      const uint64_t k0 = obs[0];
      const uint64_t k1 = n_blocks_ > 1 ? obs[1] : 0;
      slot = cache + (memo_hash(k0, k1) & ((1u << kCacheBits) - 1));
      if (slot->used && slot->k0 == k0 && slot->k1 == k1) {
        if (hit_count) (*hit_count)++;
        return slot->v;
      }
      slot->k0 = k0;
      slot->k1 = k1;
      slot->used = 1;  // value written below before return
    }
    // no-call count: nibbles equal to 15 (N/n/. encode to 15; mod.rs:49-61)
    int nocalls = 0;
    for (int b = 0; b < n_blocks_; b++) {
      uint64_t v = obs[b];
      uint64_t t = v & (v >> 1) & (v >> 2) & (v >> 3) & kLow;
      nocalls += __builtin_popcountll(t);
    }
    if (nocalls > nocall_budget_) {
      if (slot) slot->v = static_cast<int32_t>(k_);
      return static_cast<int32_t>(k_);
    }

    // counts >= cap cannot change the accept decision (see BigKMatcher)
    const int cap = max_mm_ + std::max(delta_, 1);
    int best = 256, next = 256;
    int64_t best_id = k_;
    const uint64_t* e = exp_.data();
    for (int64_t s = 0; s < k_; s++, e += n_blocks_) {
      int mm = 0;
      for (int b = 0; b < n_blocks_; b++) {
        // position mismatches iff any observed bit outside the expected mask
        uint64_t v = obs[b] & ~e[b];
        uint64_t t = v | (v >> 1);
        t |= t >> 2;
        mm += __builtin_popcountll(t & kLow);
        if (mm > cap) break;
      }
      // strict-< updates reproduce the reference's first-wins tie behavior
      // (barcode_matching.rs:132-146); clamped counts cannot flip decisions
      if (mm < best) {
        next = best;
        best = mm;
        best_id = s;
      } else if (mm < next) {
        next = mm;
      }
    }
    int32_t result = static_cast<int32_t>(best_id);
    if (best > max_mm_ || next - best < delta_) result = static_cast<int32_t>(k_);
    if (slot) slot->v = result;
    return result;
  }

 private:
  int64_t k_;
  int len_, max_mm_, delta_, n_blocks_ = 0, nocall_budget_ = 0;
  bool ok_ = true;
  bool cache_enabled_ = false;
  bool last_batch_hot_ = false;  // previous batch was >=90% cache hits
  uint64_t tail_mask_ = ~0ull;
  std::vector<uint64_t> exp_;  // [K, n_blocks] nibble-mask-packed barcodes
  std::vector<std::vector<MemoEntry>> caches_;  // one per worker slot
  std::mutex assign_mu_;  // cache state: one batch at a time per matcher
};

// ---------------------------------------------------------------------------
// Reference-architecture baseline proxy.
//
// A faithful re-creation of fqtk's OWN pipeline shape (SURVEY.md §2c /
// demux.rs:881-1001) used ONLY to measure a defensible Rust-baseline proxy
// on this host (no Rust toolchain exists in the image):
//   - one read-ahead thread per input feeding bounded chunk queues of 1000
//     owned records (fgoxide read_ahead(1000, 1000));
//   - ONE main thread doing extraction, scalar branch-and-bound barcode
//     matching with a memo cache (barcode_matching.rs:119-182), header
//     rewriting and record formatting into pooled writers;
//   - (threads - main - readers) BGZF compressor threads (libdeflate — the
//     same backend the reference's bgzf crate uses).
// Where behavior differs from Rust fqtk, the proxy is GENEROUS to the
// baseline: input decompression uses our whole-block libdeflate BGZF path
// (faster than the reference's streaming zlib-ng), so the measured number
// is an upper bound on fqtk's speed here.  See scripts/measure_baseline.py.
// ---------------------------------------------------------------------------

class RefProxyMatcher {
 public:
  RefProxyMatcher(const uint8_t* barcodes, int k, int len, int max_mm,
                  int delta)
      : k_(k), len_(len), max_mm_(max_mm), delta_(delta) {
    masks_.resize(static_cast<size_t>(k) * len);
    max_ns_ = 0;
    for (int s = 0; s < k; s++) {
      int ns = 0;
      for (int j = 0; j < len; j++) {
        uint8_t b = barcodes[s * len + j];
        masks_[s * len + j] = kIupac.encode[b];
        ns += kIupac.nocall[b];
      }
      max_ns_ = std::max(max_ns_, ns);
    }
    cache_.reserve(1 << 20);  // reference pre-sizes to 1M (ahash)
  }

  // returns sample index or -1 (unmatched); n == observed length
  int32_t assign(const uint8_t* bc, int n) {
    if (n < len_) return -1;  // too-short gate (assign() -> None)
    int nocalls = 0;
    for (int j = 0; j < n; j++) nocalls += kIupac.nocall[bc[j]];
    if (nocalls > max_mm_ + max_ns_) return -1;
    std::string key(reinterpret_cast<const char*>(bc), n);
    auto it = cache_.find(key);
    if (it != cache_.end()) return it->second;
    // linear scan with branch-and-bound (barcode_matching.rs:119-147)
    int best = -1, best_mm = 256, next_mm = 256;
    for (int s = 0; s < k_; s++) {
      int bound = std::min(255, next_mm + delta_);
      int mm = 0;
      const uint8_t* exp = masks_.data() + static_cast<size_t>(s) * len_;
      for (int j = 0; j < len_ && mm < bound; j++) {
        mm += (kIupac.encode[bc[j]] & ~exp[j]) != 0;
      }
      if (mm < best_mm) {
        next_mm = best_mm;
        best_mm = mm;
        best = s;
      } else if (mm < next_mm) {
        next_mm = mm;
      }
    }
    int32_t res = -1;
    if (best >= 0 && best_mm <= max_mm_ && next_mm - best_mm >= delta_)
      res = best;
    if (res >= 0) cache_.emplace(std::move(key), res);  // successes only
    return res;
  }

 private:
  int k_, len_, max_mm_, delta_, max_ns_ = 0;
  std::vector<uint8_t> masks_;
  std::unordered_map<std::string, int32_t> cache_;
};

// Bounded queue of parsed record chunks (read_ahead analog).
struct RefProxyQueue {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<InputBatch> q;
  bool done = false;
  static constexpr size_t kMaxChunks = 4;

  void push(InputBatch&& b) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return q.size() < kMaxChunks || done; });
    if (done) return;  // consumer bailed; drop
    q.push_back(std::move(b));
    cv_pop.notify_one();
  }
  bool pop(InputBatch* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !q.empty() || done; });
    if (q.empty()) return false;
    *out = std::move(q.front());
    q.pop_front();
    cv_push.notify_one();
    return true;
  }
  void finish() {
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_pop.notify_all();
  }
};

int64_t DemuxEngine::refproxy_run(const uint8_t* barcodes, int k, int max_mm,
                                  int delta, int reader_chunk) {
  if (!open_writers()) return -1;  // writers are deferred-open now
  const size_t n_in = parse_states_.size();
  // the reference's pooled-writer parks producers on a full queue; the
  // baseline proxy must not inherit this engine's steal-on-full assist
  if (pool_) pool_->donate_on_full.store(false);
  RefProxyMatcher matcher(barcodes, k, bc_len_, max_mm, delta);
  std::vector<std::unique_ptr<RefProxyQueue>> queues;
  for (size_t i = 0; i < n_in; i++)
    queues.push_back(std::make_unique<RefProxyQueue>());
  std::vector<std::thread> readers;
  for (size_t i = 0; i < n_in; i++) {
    readers.emplace_back([this, i, &queues, reader_chunk] {
      for (;;) {
        InputBatch ib;
        parse_input_window(i, ib, reader_chunk);
        if (ib.failed) {
          err.set(ib.error);
          break;
        }
        if (ib.recs.empty()) break;  // EOF
        queues[i]->push(std::move(ib));
        if (err.failed) break;
      }
      queues[i]->finish();
    });
  }

  // the reference's single main thread: extraction + scalar assign + write
  int64_t total = 0;
  std::vector<InputBatch> cur(n_in);
  std::vector<uint8_t> bc;
  WriteScratch sc;
  const int32_t unmatched = static_cast<int32_t>(writers_.size()) - 1;
  bool ok = true;
  while (ok) {
    size_t got = 0;
    for (size_t i = 0; i < n_in; i++) {
      cur[i] = InputBatch();
      if (queues[i]->pop(&cur[i])) got++;
    }
    if (got == 0) break;
    if (got != n_in) {
      err.set("FASTQ sources out of sync (refproxy)");
      break;
    }
    int64_t nmax = 0;
    for (auto& ib : cur)
      nmax = std::max<int64_t>(nmax, ib.recs.size());
    for (int64_t t = 0; t < nmax && ok; t++) {
      size_t present = 0;
      for (size_t i = 0; i < n_in; i++)
        if (t < static_cast<int64_t>(cur[i].recs.size())) present++;
      if (present == 0) break;
      if (present != n_in) {
        err.set("FASTQ sources out of sync (refproxy)");
        ok = false;
        break;
      }
      bc.clear();
      for (size_t i = 0; i < n_in && ok; i++) {
        const RecEntry& e = cur[i].recs[t];
        if (static_cast<int32_t>(e.seq_len) < inputs_[i].min_len) {
          err.set("refproxy: read had too few bases to demux");
          ok = false;
          break;
        }
        for (const SegmentDef& sd : inputs_[i].segments) {
          if (sd.kind != 'B') continue;
          uint32_t len = sd.length < 0 ? e.seq_len - sd.offset
                                       : static_cast<uint32_t>(sd.length);
          const uint8_t* p = cur[i].arena.data() + e.seq_off + sd.offset;
          bc.insert(bc.end(), p, p + len);
        }
      }
      if (!ok) break;
      int32_t a = matcher.assign(bc.data(), static_cast<int>(bc.size()));
      int32_t idx = a < 0 ? unmatched : a;
      if (!write_template(cur, t, idx, sc)) {
        ok = false;
        break;
      }
      total++;
    }
  }
  for (auto& q : queues) {
    std::lock_guard<std::mutex> lk(q->mu);
    q->done = true;
    q->cv_push.notify_all();
    q->cv_pop.notify_all();
  }
  for (auto& t : readers) t.join();
  finish();
  return err.failed ? -1 : total;
}

// ---------------------------------------------------------------------------
// Independent ChaCha8Rng composition (verification-only).
//
// A from-scratch scalar implementation of rand_core's seed_from_u64 (PCG32
// XSH-RR expansion), the ChaCha8 block function in rand_chacha's layout
// (64-bit counter words 12-13, 64-bit stream id 14-15 = 0), next_u64 = two
// consecutive LE u32 keystream words, and rand 0.9's StandardUniform f64
// ((x >> 11) * 2^-53).  Exists solely so tests can cross-check the
// vectorized NumPy implementation (fqtk_tpu/utils/chacha.py) against an
// independently written one — no Rust toolchain exists here to emit true
// golden vectors (see docs/PARITY.md).
// ---------------------------------------------------------------------------

namespace chacha_verify {

inline uint32_t rotl32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

inline void quarter(uint32_t s[16], int a, int b, int c, int d) {
  s[a] += s[b]; s[d] = rotl32(s[d] ^ s[a], 16);
  s[c] += s[d]; s[b] = rotl32(s[b] ^ s[c], 12);
  s[a] += s[b]; s[d] = rotl32(s[d] ^ s[a], 8);
  s[c] += s[d]; s[b] = rotl32(s[b] ^ s[c], 7);
}

void seed_expand(uint64_t state, uint32_t key[8]) {
  const uint64_t MUL = 6364136223846793005ull;
  const uint64_t INC = 11634580027462260723ull;
  for (int i = 0; i < 8; i++) {
    state = state * MUL + INC;
    uint32_t xorshifted = static_cast<uint32_t>(((state >> 18) ^ state) >> 27);
    uint32_t rot = static_cast<uint32_t>(state >> 59);
    key[i] = rot ? ((xorshifted >> rot) | (xorshifted << (32 - rot)))
                 : xorshifted;
  }
}

void block(const uint32_t key[8], uint64_t counter, uint32_t out[16]) {
  uint32_t in[16] = {0x61707865, 0x3320646e, 0x79622d32, 0x6b206574,
                     key[0],     key[1],     key[2],     key[3],
                     key[4],     key[5],     key[6],     key[7],
                     static_cast<uint32_t>(counter),
                     static_cast<uint32_t>(counter >> 32),
                     0,          0};
  memcpy(out, in, sizeof(in));
  for (int r = 0; r < 4; r++) {  // 8 rounds = 4 double rounds
    quarter(out, 0, 4, 8, 12);
    quarter(out, 1, 5, 9, 13);
    quarter(out, 2, 6, 10, 14);
    quarter(out, 3, 7, 11, 15);
    quarter(out, 0, 5, 10, 15);
    quarter(out, 1, 6, 11, 12);
    quarter(out, 2, 7, 8, 13);
    quarter(out, 3, 4, 9, 14);
  }
  for (int i = 0; i < 16; i++) out[i] += in[i];
}

}  // namespace chacha_verify

}  // namespace

FQTK_API void fqtk_chacha8_verify_u64(uint64_t seed, int64_t n,
                                      uint64_t* out) {
  uint32_t key[8];
  chacha_verify::seed_expand(seed, key);
  uint64_t counter = 0;
  uint32_t words[16];
  int wpos = 16;
  for (int64_t i = 0; i < n; i++) {
    if (wpos >= 16) {
      chacha_verify::block(key, counter++, words);
      wpos = 0;
    }
    uint64_t lo = words[wpos], hi = words[wpos + 1];
    wpos += 2;
    out[i] = lo | (hi << 32);
  }
}

FQTK_API void fqtk_chacha8_verify_f64(uint64_t seed, int64_t n, double* out) {
  std::vector<uint64_t> u(n);
  fqtk_chacha8_verify_u64(seed, n, u.data());
  for (int64_t i = 0; i < n; i++)
    out[i] = static_cast<double>(u[i] >> 11) *
             (1.0 / 9007199254740992.0 /* 2^53 */);
}

// Stateful ChaCha8 keep-mask generator for the subsample hot path.  The
// NumPy ChaCha8Rng (fqtk_tpu/utils/chacha.py) remains the spec — itself
// pinned to rand_chacha semantics by the verify exports above and the
// ECRYPT vectors in tests — but its ~50ns/draw mask production runs on a
// producer thread that competes with the compressor pool for host cores
// (~0.35 cores at the measured 6M reads/s).  This generator produces the
// identical mask at ~13ns/draw (measured 76M draws/s): one u64 per record set = two consecutive
// keystream words (lo | hi<<32), keep = ((u >> 11) * 2^-53) < fraction in
// the same exact f64 arithmetic ((u>>11) < 2^53 is exactly representable
// and the scale is a power of two, so native and NumPy masks are
// bit-identical, which tests/test_subsample.py pins).  State persists
// across calls so chunk boundaries (including odd sizes at progress-log
// edges) continue the stream exactly like ChaCha8Rng.next_u64_batch.
struct ChaChaMaskRng {
  uint32_t key[8];
  uint64_t counter = 0;
  uint32_t words[16];
  int wpos = 16;  // exhausted; wpos is always even (draws consume pairs)
};

FQTK_API ChaChaMaskRng* fqtk_rng_new(uint64_t seed) {
  auto* r = new ChaChaMaskRng();
  chacha_verify::seed_expand(seed, r->key);
  return r;
}

namespace {

// 8 consecutive ChaCha8 blocks with the state transposed to [word][block]
// so every quarter-round op is a straight-line loop over 8 lanes — gcc
// autovectorizes these into 256-bit integer ops (the same layout the
// NumPy implementation uses across thousands of blocks).  Output order is
// identical to 8 sequential chacha_verify::block calls.
inline void chacha8_blocks8(const uint32_t key[8], uint64_t counter0,
                            uint32_t out[8][16]) {
  uint32_t s[16][8];
  static const uint32_t kConst[4] = {0x61707865, 0x3320646e, 0x79622d32,
                                     0x6b206574};
  for (int w = 0; w < 4; w++)
    for (int b = 0; b < 8; b++) s[w][b] = kConst[w];
  for (int w = 0; w < 8; w++)
    for (int b = 0; b < 8; b++) s[4 + w][b] = key[w];
  for (int b = 0; b < 8; b++) {
    uint64_t c = counter0 + static_cast<uint64_t>(b);
    s[12][b] = static_cast<uint32_t>(c);
    s[13][b] = static_cast<uint32_t>(c >> 32);
    s[14][b] = 0;
    s[15][b] = 0;
  }
  uint32_t w_[16][8];
  memcpy(w_, s, sizeof(s));
#define FQTK_QR(a, bq, c, d)                                     \
  for (int b = 0; b < 8; b++) {                                  \
    w_[a][b] += w_[bq][b];                                       \
    uint32_t x = w_[d][b] ^ w_[a][b];                            \
    w_[d][b] = (x << 16) | (x >> 16);                            \
    w_[c][b] += w_[d][b];                                        \
    x = w_[bq][b] ^ w_[c][b];                                    \
    w_[bq][b] = (x << 12) | (x >> 20);                           \
    w_[a][b] += w_[bq][b];                                       \
    x = w_[d][b] ^ w_[a][b];                                     \
    w_[d][b] = (x << 8) | (x >> 24);                             \
    w_[c][b] += w_[d][b];                                        \
    x = w_[bq][b] ^ w_[c][b];                                    \
    w_[bq][b] = (x << 7) | (x >> 25);                            \
  }
  for (int r = 0; r < 4; r++) {  // 8 rounds = 4 double rounds
    FQTK_QR(0, 4, 8, 12)
    FQTK_QR(1, 5, 9, 13)
    FQTK_QR(2, 6, 10, 14)
    FQTK_QR(3, 7, 11, 15)
    FQTK_QR(0, 5, 10, 15)
    FQTK_QR(1, 6, 11, 12)
    FQTK_QR(2, 7, 8, 13)
    FQTK_QR(3, 4, 9, 14)
  }
#undef FQTK_QR
  for (int w = 0; w < 16; w++)
    for (int b = 0; b < 8; b++) out[b][w] = w_[w][b] + s[w][b];
}

}  // namespace

FQTK_API void fqtk_rng_keep_mask(ChaChaMaskRng* r, double fraction, int64_t n,
                                 uint8_t* out) {
  // keep <=> ((u >> 11) * 2^-53) < fraction, evaluated by the spec in f64.
  // Both sides of that compare are exact doubles ((u >> 11) < 2^53 is
  // exactly representable; the scale is a power of two), so it is
  // EXACTLY the integer predicate (u >> 11) < ceil(fraction * 2^53):
  // fraction * 2^53 is an exact f64 product, x < t for integer x equals
  // x < ceil(t) (and ceil is the identity when t is integral, e.g.
  // fraction = 1.0 -> 2^53, which every draw satisfies).  The integer
  // form vectorizes; the f64 form is what tests pin it against.
  const uint64_t thresh =
      static_cast<uint64_t>(std::ceil(fraction * 9007199254740992.0));
  int64_t i = 0;
  // drain the partial block a previous odd-sized call left behind
  while (i < n && r->wpos < 16) {
    uint64_t u = static_cast<uint64_t>(r->words[r->wpos]) |
                 (static_cast<uint64_t>(r->words[r->wpos + 1]) << 32);
    r->wpos += 2;
    out[i++] = (u >> 11) < thresh ? 1 : 0;
  }
  // 8-block groups (64 draws) through the lane-transposed core; the
  // 128 LE u32 words ARE 64 LE u64 draws, so compare them directly
  while (n - i >= 64) {
    uint32_t w8[8][16];
    chacha8_blocks8(r->key, r->counter, w8);
    r->counter += 8;
    uint64_t u64s[64];
    memcpy(u64s, w8, sizeof(u64s));
    for (int j = 0; j < 64; j++) out[i + j] = (u64s[j] >> 11) < thresh;
    i += 64;
  }
  // whole single blocks (8 draws per block)
  while (n - i >= 8) {
    uint32_t w[16];
    chacha_verify::block(r->key, r->counter++, w);
    for (int j = 0; j < 16; j += 2) {
      uint64_t u = static_cast<uint64_t>(w[j]) |
                   (static_cast<uint64_t>(w[j + 1]) << 32);
      out[i++] = (u >> 11) < thresh ? 1 : 0;
    }
  }
  // tail: buffer one more block and leave the remainder for the next call
  if (i < n) {
    chacha_verify::block(r->key, r->counter++, r->words);
    r->wpos = 0;
    while (i < n) {
      uint64_t u = static_cast<uint64_t>(r->words[r->wpos]) |
                   (static_cast<uint64_t>(r->words[r->wpos + 1]) << 32);
      r->wpos += 2;
      out[i++] = (u >> 11) < thresh ? 1 : 0;
    }
  }
}

FQTK_API void fqtk_rng_free(ChaChaMaskRng* r) { delete r; }

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

FQTK_API DemuxEngine* fqtk_demux_new(int n_threads, int compression_level) {
  auto* e = new DemuxEngine();
  e->init(n_threads, compression_level);
  return e;
}

FQTK_API int fqtk_demux_add_input(DemuxEngine* e, const char* path,
                                  const char* structure_str,
                                  const int32_t* offsets,
                                  const int32_t* lengths, const char* kinds,
                                  int n_segs) {
  std::vector<SegmentDef> segs(n_segs);
  for (int i = 0; i < n_segs; i++)
    segs[i] = SegmentDef{offsets[i], lengths[i], kinds[i]};
  return e->add_input(path, structure_str, segs.data(), n_segs) ? 0 : -1;
}

FQTK_API int fqtk_demux_add_sample_writer(DemuxEngine* e, const char* path) {
  return e->add_sample_writer(path) ? 0 : -1;
}

FQTK_API void fqtk_demux_end_sample(DemuxEngine* e) { e->end_sample(); }

FQTK_API void fqtk_demux_configure(DemuxEngine* e, int bc_len,
                                   int nocall_budget, int skip_too_few,
                                   const char* first_sample_id,
                                   const char* first_barcode,
                                   const char* out_types, int n_out_types,
                                   int pack_masks) {
  e->configure(bc_len, nocall_budget, skip_too_few, first_sample_id,
               first_barcode, out_types, n_out_types, pack_masks);
}

// ---- pipelined mode ----

FQTK_API int fqtk_demux_pipe_start(DemuxEngine* e, int64_t batch,
                                   int ramp) {
  return e->pipe_start(batch, ramp != 0) ? 0 : -1;
}

FQTK_API int64_t fqtk_demux_pipe_acquire(DemuxEngine* e, int32_t* slot_out,
                                         const uint8_t** bc_out,
                                         int64_t* skipped_out) {
  return e->pipe_acquire(slot_out, bc_out, skipped_out);
}

FQTK_API int fqtk_demux_pipe_submit(DemuxEngine* e, int32_t slot,
                                    const int32_t* assigned, int64_t n) {
  return e->pipe_submit(slot, assigned, n) ? 0 : -1;
}

FQTK_API int fqtk_demux_pipe_finish(DemuxEngine* e) {
  return e->pipe_finish() ? 0 : -1;
}

FQTK_API int64_t fqtk_demux_pipe_exceptional(DemuxEngine* e, int32_t slot,
                                             const int32_t** rows,
                                             const uint8_t** bytes) {
  return e->pipe_exceptional(slot, rows, bytes);
}

FQTK_API void fqtk_demux_counts(DemuxEngine* e, int64_t* out, int64_t n) {
  e->get_counts(out, n);
}

// Matcher-only baseline proxy bench: the reference's scalar branch-and-bound
// scan + memo cache over an arbitrary whitelist (used for the 737K config,
// whose 737K-sample e2e is impossible — fd limits — for ANY implementation).
// Returns reads/sec.
FQTK_API double fqtk_refproxy_matcher_bench(const uint8_t* barcodes, int64_t k,
                                            int len, int max_mm, int delta,
                                            const uint8_t* obs, int64_t n) {
  RefProxyMatcher m(barcodes, static_cast<int>(k), len, max_mm, delta);
  uint64_t t0 = now_ns();
  int64_t acc = 0;
  for (int64_t i = 0; i < n; i++) acc += m.assign(obs + i * len, len);
  double dt = (now_ns() - t0) * 1e-9;
  if (acc == -1234567) return -1;  // keep the loop observable
  return dt > 0 ? n / dt : 0;
}

// ---- big-K pigeonhole matcher ----

FQTK_API BigKMatcher* fqtk_bigk_new(const uint8_t* barcodes, int64_t k,
                                    int len, int max_mm, int delta) {
  auto* m = new BigKMatcher(barcodes, k, len, max_mm, delta);
  if (!m->ok()) {
    delete m;
    return nullptr;
  }
  return m;
}

FQTK_API void fqtk_bigk_assign(BigKMatcher* m, const uint8_t* obs_packed,
                               int64_t n, int64_t stride, int32_t* out,
                               int n_threads) {
  m->assign_batch(obs_packed, n, stride, out, n_threads);
}

FQTK_API void fqtk_bigk_free(BigKMatcher* m) { delete m; }

// ---- small-K brute-force host matcher ----

FQTK_API SmallKMatcher* fqtk_smallk_new(const uint8_t* barcodes, int64_t k,
                                        int len, int max_mm, int delta) {
  auto* m = new SmallKMatcher(barcodes, k, len, max_mm, delta);
  if (!m->ok()) {
    delete m;
    return nullptr;
  }
  return m;
}

FQTK_API void fqtk_smallk_assign(SmallKMatcher* m, const uint8_t* obs_packed,
                                 int64_t n, int64_t stride, int32_t* out,
                                 int n_threads) {
  m->assign_batch(obs_packed, n, stride, out, n_threads);
}

FQTK_API void fqtk_smallk_free(SmallKMatcher* m) { delete m; }

// ---- fused host-matcher pipeline (engine-side assignment) ----

static void fused_smallk_call(void* m, const uint8_t* obs, int64_t n,
                              int64_t stride, int32_t* out, int n_threads) {
  static_cast<SmallKMatcher*>(m)->assign_batch(obs, n, stride, out,
                                               n_threads);
}

static void fused_bigk_call(void* m, const uint8_t* obs, int64_t n,
                            int64_t stride, int32_t* out, int n_threads) {
  static_cast<BigKMatcher*>(m)->assign_batch(obs, n, stride, out, n_threads);
}

// kind: 0 = SmallKMatcher, 1 = BigKMatcher.  Caller keeps the matcher alive
// until the engine is freed.  Must precede fqtk_demux_pipe_start.
FQTK_API int fqtk_demux_pipe_fuse_host_matcher(DemuxEngine* e, void* matcher,
                                               int kind, int n_threads) {
  return e->pipe_fuse_host_matcher(
             matcher, kind == 1 ? fused_bigk_call : fused_smallk_call,
             n_threads)
             ? 1
             : 0;
}

FQTK_API int fqtk_demux_pipe_fused_poll(DemuxEngine* e, int timeout_ms,
                                        int64_t* total, int64_t* skipped) {
  return e->pipe_fused_poll(timeout_ms, total, skipped);
}

// Resolved SIMD dispatch level the candidate scans will use right now
// (0=scalar, 1=avx2, 2=avx512), i.e. min(FQTK_SIMD cap, CPU capability).
// Tests assert this so an FQTK_SIMD typo can't silently run the wrong scan.
// Decompress-only calibration: stream `path` to EOF on the calling thread,
// discarding the output.  Returns decompressed bytes (-1 on open/stream
// error), writes the thread-CPU seconds to *cpu_s and the stream kind to
// *kind (0 = plain, 1 = single-member gzip, 2 = multi-member gzip,
// 3 = BGZF).  bench.py uses it to measure the SERIAL-inflate bound of an
// input: inflate within ONE deflate member cannot be parallelized by any
// implementation (each block's dictionary is the previous output), so for
// kind==1 inputs n_reads / max_input(inflate_cpu_s) caps e2e throughput.
// Multi-member/BGZF inputs (kind 2/3) are block-parallel decodable in
// principle, so no serial bound is claimed for them.
FQTK_API int64_t fqtk_inflate_bench(const char* path, double* cpu_s,
                                    int* kind) {
  InputStream in(path);
  if (!in.ok()) return -1;
  std::vector<uint8_t> buf(1 << 20);
  uint64_t t0 = thread_cpu_ns();
  int64_t total = 0;
  for (;;) {
    size_t n = in.read(buf.data(), buf.size());
    if (n == 0) break;
    total += n;
  }
  if (!in.ok()) return -1;
  *cpu_s = (thread_cpu_ns() - t0) * 1e-9;
  if (kind) {
    if (in.is_bgzf())
      *kind = 3;
    else if (in.is_gzipped())
      *kind = in.member_count() > 1 ? 2 : 1;
    else
      *kind = 0;
  }
  return total;
}

// Deflate library the build linked: 1 = libdeflate (BGZF blocks inflate
// whole, faster compression), 0 = zlib only.
FQTK_API int fqtk_deflate_backend(void) {
#ifdef FQTK_HAVE_LIBDEFLATE
  return 1;
#else
  return 0;
#endif
}

FQTK_API int fqtk_simd_level(void) {
#ifdef FQTK_X86_SIMD
  const int cap = simd_level_cap();
  if (cap >= 2 && __builtin_cpu_supports("avx512bw")) return 2;
  if (cap >= 1 && __builtin_cpu_supports("avx2")) return 1;
#endif
  return 0;
}

// Reference-architecture measurement mode (see RefProxyMatcher above):
// runs the whole demux on the host with fqtk's own pipeline shape to
// produce a measured baseline proxy.  `barcodes` is the K whitelist rows
// concatenated (each bc_len bytes, uppercase).
FQTK_API int64_t fqtk_demux_refproxy_run(DemuxEngine* e,
                                         const uint8_t* barcodes, int k,
                                         int max_mm, int delta) {
  return e->refproxy_run(barcodes, k, max_mm, delta, 1000);
}

FQTK_API void fqtk_demux_stats(DemuxEngine* e, double* out, int n) {
  e->get_stats(out, n);
}

FQTK_API const char* fqtk_demux_error(DemuxEngine* e) {
  return e->err.failed.load() ? e->err.msg.c_str() : "";
}

FQTK_API void fqtk_demux_free(DemuxEngine* e) { delete e; }

// --------------------------------------------------------------------------
// standalone BGZF writer API (used by subsample and tests)
// --------------------------------------------------------------------------

struct StandaloneWriter {
  std::unique_ptr<CompressorPool> pool;
  std::unique_ptr<BgzfWriter> writer;
};

FQTK_API StandaloneWriter* fqtk_bgzf_open(const char* path, int level,
                                          int threads) {
  auto* s = new StandaloneWriter();
  // queue floor: threads <= 0 must not create a 0-capacity queue whose
  // submit() would block forever (the pool ctor already floors workers)
  s->pool = std::make_unique<CompressorPool>(threads,
                                             std::max(8, threads * 50));
  s->writer = std::make_unique<BgzfWriter>(path, level, s->pool.get());
  if (!s->writer->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

FQTK_API void fqtk_bgzf_write(StandaloneWriter* s, const uint8_t* data,
                              int64_t len) {
  s->writer->write(data, static_cast<size_t>(len));
}

FQTK_API int fqtk_bgzf_close(StandaloneWriter* s) {
  int rc = s->writer->close() ? 0 : -1;
  s->pool->stop();
  delete s;
  return rc;
}

// --------------------------------------------------------------------------
// subsample C API
// --------------------------------------------------------------------------

FQTK_API SubsampleEngine* fqtk_subsample_new(int n_threads,
                                             int compression_level) {
  auto* e = new SubsampleEngine();
  e->init(n_threads, compression_level);
  return e;
}

FQTK_API int fqtk_subsample_add_input(SubsampleEngine* e, const char* in_path,
                                      const char* out_path) {
  return e->add_input(in_path, out_path) ? 0 : -1;
}

FQTK_API void fqtk_subsample_configure(SubsampleEngine* e, int check_names,
                                       int parallel) {
  e->configure(check_names != 0, parallel != 0);
}

FQTK_API int64_t fqtk_subsample_chunk(SubsampleEngine* e,
                                      const uint8_t* keep_mask, int64_t n,
                                      int64_t* kept_out) {
  return e->process_chunk(keep_mask, n, kept_out);
}

FQTK_API int fqtk_subsample_finish(SubsampleEngine* e) {
  return e->finish() ? 0 : -1;
}

FQTK_API const char* fqtk_subsample_error(SubsampleEngine* e) {
  return e->err.failed.load() ? e->err.msg.c_str() : "";
}

FQTK_API void fqtk_subsample_stats(SubsampleEngine* e, double* out, int n) {
  e->get_stats(out, n);
}

FQTK_API void fqtk_subsample_free(SubsampleEngine* e) { delete e; }
