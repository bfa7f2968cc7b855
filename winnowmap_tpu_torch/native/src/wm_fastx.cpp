// Batched FASTA/FASTQ (optionally gzipped) reader.
//
// Capability parity with the reference sequence input layer
// (reference: src/bseq.c + src/kseq.h): multi-line FASTA, 4-line FASTQ with
// multi-line quality, '>'/'@' records, name = up to first whitespace,
// comment = rest of header line.  Batches are returned as concatenated
// buffers + offsets so the Python layer slices them zero-copy.

#include "wm_base.h"

#include <zlib.h>

#include <string>
#include <vector>

namespace {

struct GzLine {
  gzFile fp = nullptr;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof_flag = false;

  bool open(const char* fn) {
    fp = gzopen(fn, "rb");
    if (!fp) return false;
    gzbuffer(fp, 1 << 20);
    buf.resize(1 << 16);
    return true;
  }
  void close() {
    if (fp) gzclose(fp);
    fp = nullptr;
  }
  int getc_() {
    if (pos >= len) {
      if (eof_flag) return -1;
      int r = gzread(fp, buf.data(), (unsigned)buf.size());
      if (r <= 0) {
        eof_flag = true;
        return -1;
      }
      len = (size_t)r;
      pos = 0;
    }
    return (unsigned char)buf[pos++];
  }
  // append chars until delimiter (newline); returns false on EOF-with-nothing
  bool getuntil_nl(std::string& out) {
    int c = getc_();
    if (c < 0) return false;
    while (c >= 0 && c != '\n') {
      if (c != '\r') out.push_back((char)c);
      c = getc_();
    }
    return true;
  }
  int peek() {
    if (pos >= len) {
      if (eof_flag) return -1;
      int r = gzread(fp, buf.data(), (unsigned)buf.size());
      if (r <= 0) {
        eof_flag = true;
        return -1;
      }
      len = (size_t)r;
      pos = 0;
    }
    return (unsigned char)buf[pos];
  }
};

struct FastxFile {
  GzLine in;
  int pending_hdr = 0;  // 1 if a header char was already consumed
  std::string hdr_line;
};

struct Batch {
  std::string names, comments, seqs, quals;
  std::vector<int64_t> name_off{0}, comment_off{0}, seq_off{0}, qual_off{0};
  int64_t n = 0;
};

}  // namespace

extern "C" {

void* wm_fastx_open(const char* fn) {
  FastxFile* f = new FastxFile();
  if (!f->in.open(fn)) {
    delete f;
    return nullptr;
  }
  return f;
}

void wm_fastx_close(void* h) {
  if (!h) return;
  FastxFile* f = (FastxFile*)h;
  f->in.close();
  delete f;
}

// Reads records until >= max_bp bases are buffered (always completes the
// record in progress).  Returns an opaque batch handle or nullptr at EOF.
void* wm_fastx_read_batch(void* h, int64_t max_bp) {
  FastxFile* f = (FastxFile*)h;
  Batch* b = new Batch();
  std::string line;

  while ((int64_t)b->seqs.size() < max_bp) {
    // find the next header
    if (!f->pending_hdr) {
      int c;
      do {
        c = f->in.getc_();
      } while (c >= 0 && c != '>' && c != '@');
      if (c < 0) break;
      f->pending_hdr = c;
    }
    int hdr = f->pending_hdr;
    f->pending_hdr = 0;
    line.clear();
    if (!f->in.getuntil_nl(line)) break;
    // split name / comment on first whitespace
    size_t sp = line.find_first_of(" \t");
    std::string name = sp == std::string::npos ? line : line.substr(0, sp);
    std::string comment;
    if (sp != std::string::npos) {
      size_t cs = line.find_first_not_of(" \t", sp);
      if (cs != std::string::npos) comment = line.substr(cs);
    }
    size_t seq_start = b->seqs.size();
    // sequence lines until next header or '+'
    for (;;) {
      int c = f->in.peek();
      if (c < 0 || c == '>' || c == '@' || c == '+') break;
      line.clear();
      if (!f->in.getuntil_nl(line)) break;
      b->seqs.append(line);
    }
    size_t slen = b->seqs.size() - seq_start;
    size_t qual_start = b->quals.size();
    if (hdr == '@') {
      int c = f->in.peek();
      if (c == '+') {
        line.clear();
        f->in.getuntil_nl(line);  // discard the '+' line
        while (b->quals.size() - qual_start < slen) {
          line.clear();
          if (!f->in.getuntil_nl(line)) break;
          b->quals.append(line);
        }
      }
    }
    b->names.append(name);
    b->comments.append(comment);
    b->name_off.push_back((int64_t)b->names.size());
    b->comment_off.push_back((int64_t)b->comments.size());
    b->seq_off.push_back((int64_t)b->seqs.size());
    b->qual_off.push_back((int64_t)b->quals.size());
    b->n++;
  }
  if (b->n == 0) {
    delete b;
    return nullptr;
  }
  return b;
}

int64_t wm_batch_n(void* bh) { return ((Batch*)bh)->n; }
const char* wm_batch_names(void* bh) { return ((Batch*)bh)->names.data(); }
const char* wm_batch_comments(void* bh) { return ((Batch*)bh)->comments.data(); }
const char* wm_batch_seqs(void* bh) { return ((Batch*)bh)->seqs.data(); }
const char* wm_batch_quals(void* bh) { return ((Batch*)bh)->quals.data(); }
const int64_t* wm_batch_name_off(void* bh) { return ((Batch*)bh)->name_off.data(); }
const int64_t* wm_batch_comment_off(void* bh) {
  return ((Batch*)bh)->comment_off.data();
}
const int64_t* wm_batch_seq_off(void* bh) { return ((Batch*)bh)->seq_off.data(); }
const int64_t* wm_batch_qual_off(void* bh) { return ((Batch*)bh)->qual_off.data(); }
void wm_batch_free(void* bh) { delete (Batch*)bh; }

}  // extern "C"
